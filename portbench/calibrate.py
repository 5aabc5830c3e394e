"""The readings a cell's limits are set from (``portbench/limits/``).

    python3 -m portbench.calibrate --workload headline.orbit \
        --seeds 101,102,...,112 --control 3 --seconds 4

runs the cell on the card once per seed, each with a short window at the
cell's own load and sizes, and prints per seed the program's numbers
and, on the first ``--control`` seeds, the control's: the plain
reference computed in bfloat16 (the precision below the configuration's
float32) in the program's place, on the same kept items. The last line
is the summary: the lower reading of each number (the largest the
program gives) and the upper (the smallest the control gives). The
benchmark's own runs never run the control.

    python3 -m portbench.calibrate --workload world.orbit \
        --seeds 201,202,203 --control 0 --fault lod_up

reads a fault planted under the timed path (``faults.py``) instead of
the sound program: the summary's ``least`` is then the smallest reading
of each number over the seeds, which a limit has to stay under for the
fault to fail it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import bench, check, faults


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated run seeds")
    p.add_argument("--control", type=int, default=3,
                   help="read the control on the first N seeds")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault",
                   choices=faults.FRAME + faults.SHADE + faults.BLOCK,
                   help="plant this fault under the timed path")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.fault:
        faults.plant(setattr, args.workload, args.fault)
    lower = dict.fromkeys(check.NAMES, 0.0)
    least = dict.fromkeys(check.NAMES, float("inf"))
    upper = dict.fromkeys(check.NAMES, float("inf"))
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        out = bench.run_cell(args.workload, seed, args.seconds, False,
                             t_start=t0, device=args.device,
                             control=k < args.control)
        got = {n: out["checks"][n]["value"] for n in check.NAMES}
        line = dict(seed=seed, correct=out["correct"],
                    attempted=out["attempted"], failed=out["failed"],
                    program=got, seconds=time.perf_counter() - t0)
        for n in check.NAMES:
            lower[n] = max(lower[n], got[n])
            least[n] = min(least[n], got[n])
        if "control" in out:
            line["control"] = out["control"]
            for n in check.NAMES:
                upper[n] = min(upper[n], out["control"]["numbers"][n])
        print(json.dumps(line), flush=True)
    summary = dict(workload=args.workload, seeds=len(seeds), lower=lower,
                   upper=upper)
    if args.fault:
        summary = dict(workload=args.workload, seeds=len(seeds),
                       fault=args.fault, least=least)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
