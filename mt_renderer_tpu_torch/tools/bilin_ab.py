"""A/B of four forms of the bilinear contraction over the one quad-row
gather, on the card.

    python -m mt_renderer_tpu_torch.tools.bilin_ab

The counterpart of ``tools/bench/bilin_ab.py``: the same scene's quad
pool (``build_demo_batch(instances=16, skinned=False, subdiv=2)``), the
same ``ROWS`` = 8,355,840 rows per set and the same seeded indices and
fractions (``default_rng(0)``, ``N`` = 8 sets). Each form gathers the
rows and filters them:

  einsum       f32 weights x u8→f32 quad, ``torch.einsum`` (the form the
               reference's production shade used)
  swar         the u32 SWAR form in plain torch ops (int64 fields):
               ``device.bilin_swar_reference``
  swar-kernel  the same in one hand-written kernel with the gather fused:
               K4, ``device.bilin_swar`` (``csrc/bilin_swar.cu``)
  planar       the gathered rows transposed to (16, n), planar f32 math

and is timed with CUDA events around one call per set, the median over
repeats of the mean over the sets. Prints ms and ns/row per form, and
checks that the kernel equals its plain version bit for bit. Refuses to
run without a CUDA device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene import demo

from ..render import device as dv
from . import card_line, cuda_times, median, require_cuda

N = 8
ROWS = 8_355_840


def probe_inputs(device, *, rows: int = ROWS, sets: int = N):
    """(quad pool (npool, 16) u8, the same as u32 words (npool, 4) i32,
    idx (sets, rows) i32, f (2, sets, rows) f32) on ``device``."""
    batch = demo.build_demo_batch(instances=16, skinned=False, subdiv=2)
    pool = dv.upload(batch, device=device).mip_pool
    rng = np.random.default_rng(0)
    idx = rng.integers(0, pool.shape[0], (sets, rows), dtype=np.int32)
    f = rng.random((2, sets, rows), dtype=np.float32)
    return (pool, pool.view(torch.int32), torch.from_numpy(idx).to(device),
            torch.from_numpy(f).to(device))


def run_einsum(pool, pool_u32, idx, fx, fy):
    quad = pool[idx.clamp(min=0).long()].reshape(-1, 4, 4).to(torch.float32)
    wq = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy,
                      fx * fy], -1)
    return torch.einsum("nq,nqc->cn", wq, quad)


def run_swar(pool, pool_u32, idx, fx, fy):
    return dv.bilin_swar_reference(pool_u32, idx, fx, fy)


def run_swar_kernel(pool, pool_u32, idx, fx, fy):
    return dv.bilin_swar(pool_u32, idx, fx, fy)


def run_planar(pool, pool_u32, idx, fx, fy):
    qt = pool[idx.clamp(min=0).long()].T.to(torch.float32)       # (16, n)
    w = [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy]
    return torch.stack([w[0] * qt[c] + w[1] * qt[4 + c] + w[2] * qt[8 + c]
                        + w[3] * qt[12 + c] for c in range(4)])


FORMS = {"einsum": run_einsum, "swar": run_swar,
         "swar-kernel": run_swar_kernel, "planar": run_planar}


def timings(device=None, *, repeats: int = 6) -> dict:
    """{form: ms per set of ROWS rows} on the card, the median over
    ``repeats``, after the kernel is checked against its plain version
    on set 0 (raises if they differ)."""
    dev = require_cuda(device)
    pool, pool_u32, idx, f = probe_inputs(dev)
    args = [(pool, pool_u32, idx[s], f[0, s], f[1, s]) for s in range(N)]
    got = run_swar_kernel(*args[0])
    want = run_swar(*args[0])
    n_diff = int((got != want).sum())
    if n_diff:
        raise AssertionError(f"bilin_swar differs from its plain version "
                             f"on {n_diff} of {ROWS} rows")
    return {name: median(cuda_times(lambda s, fn=fn: fn(*args[s]), dev,
                                    repeats, calls=N))
            for name, fn in FORMS.items()}


def main() -> int:
    dev = require_cuda()
    print(f"card: {torch.cuda.get_device_name(dev)}; {card_line()}",
          flush=True)
    res = timings(dev)
    print(f"=== medians ({ROWS:,} rows per set, {N} sets, gather "
          f"included; swar-kernel equals swar bit for bit) ===", flush=True)
    for name, ms in res.items():
        print(f"{name:12s}: {ms!r} ms  ({ms / ROWS * 1e6!r} ns/row)",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
