"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload headline.orbit --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout. Prints the checks (each number compared
beside its limit) as the last lines of standard error, and the result
as the last line of standard output: one JSON object with ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace
1`` the per-layer metrics, ``busy_s``, ``window_s`` and ``breakdown``),
``checks`` last. Exits non-zero, printing no result, without enough CUDA
devices, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(CHECKOUT / "build" / "portbench" / sub)
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.run", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import bench

    b = bench.Bench()
    chips = b.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    out = bench.run_cell(args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=T_START, bench=b)
    found = bench.banned_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
