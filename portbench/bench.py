"""One run of one cell: set-up, the timed window, the check, the result.

Everything a cell is made of is found by name under ``portbench/``:
``BENCHMARK.json`` (beside the folder) names the cell's configuration
and traffic; ``configs/<config>.json`` holds the configuration's sizes
and names its scene builder (``scenes/<builder>.py``, under the
``Bench``'s root);
``traffic/<mix>.json`` the mix (``loops``); ``metrics/<metric>.py`` each
per-layer metric's reader (``read(ctx) -> float | None``), or, for a
metric split by the end-to-end metric it moves (``idle_share.frame``,
``idle_share.served``), one reader of the name before the first dot
(``metrics/idle_share.py``);
``limits/<cell>.json`` the limits of the correctness numbers.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import check, loops, program, trace
from .scenes import builder

ROOT = Path(__file__).resolve().parent          # portbench/
SPEC = ROOT.parent / "BENCHMARK.json"
BANNED = ("jax", "jaxlib", "flax", "mt_renderer_tpu")


class Bench:
    """The benchmark's files, found by name under ``root``."""

    def __init__(self, root: Path = ROOT, spec: Path | None = None):
        self.root = Path(root)
        self.spec = json.loads(Path(spec or SPEC).read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return json.loads((self.root / "configs" / f"{name}.json").read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / "traffic" / f"{name}.json").read_text())

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``, else of
        ``metrics/<metric before its first dot>.py``."""
        path = self.root / "metrics" / f"{metric}.py"
        if not path.is_file():
            path = path.with_name(metric.split(".")[0] + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + path.stem.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        """The cell's per-layer metrics: those whose ``workloads`` list
        it."""
        return [m for m in self.spec["per_layer"]
                if workload in m["workloads"]]


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def banned_modules() -> list:
    """Top-level module names (compared whole) that no run may load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def device_info(device: torch.device, chips: int) -> dict:
    if device.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                    count=chips,
                    memory_peak_bytes=int(torch.cuda.max_memory_allocated(
                        device)))
    return dict(platform="cpu", kind="cpu", count=chips, memory_peak_bytes=0)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             t_start: float, device="cuda", bench: Bench | None = None,
             overrides: dict | None = None, control: bool = False) -> dict:
    """One run → the result dict (the last line's keys, ``checks``
    last). ``overrides`` replaces configuration keys (the CPU tests'
    small sizes); ``control`` also judges the control (the reference in
    bfloat16 in the program's place, on the same kept items) and puts
    its numbers and verdict under ``"control"``."""
    bench = bench or Bench()
    seed %= 1 << 63               # any whole number; NumPy wants it >= 0
    wl = bench.workload(workload)
    cfg = dict(bench.config(wl["config"]), **(overrides or {}))
    traffic = bench.traffic(wl["traffic"])
    lim = check.limits(bench.root, workload)
    dev = torch.device(device)
    torch.manual_seed(seed)

    marks = [("start", t_start), ("imports", time.perf_counter())]
    arrays = builder(cfg["builder"], bench.root).build(cfg, seed)
    marks.append(("scene arrays", time.perf_counter()))
    loop = loops.Loop(cfg, traffic, arrays, dev, seed)
    marks.append(("upload and program", time.perf_counter()))
    warm = [loop.step()["ms"] for _ in range(traffic["warmup"])]
    program_flushed = program.flush_overflow()
    loop.sync()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    log("set-up " + ", ".join(f"{n} {b - a:.3f} s" for (_, a), (n, b)
                               in zip(marks, marks[1:]))
        + f" (items {', '.join(f'{m:.1f}' for m in warm)} ms; engine "
        f"sizing {loop.size_s:.3f} s; artifact {loop.artifact_bytes} B)")

    sampler = loops.Sampler(traffic["sample"], seed)
    if traced:
        loop.spans = True
        guarded = loop.engine is not None and loop.trace_guard()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("window"):
                win = loops.window(loop, min(seconds,
                                             traffic["trace_seconds"]),
                                   sampler)
                loop.sync()
        t_tr = time.perf_counter()
        traced_sum = trace.summary(trace.read(prof), win["attempted"])
        del prof
        log(f"trace read in {time.perf_counter() - t_tr:.3f} s")
    else:
        win = loops.window(loop, seconds, sampler)
    info = device_info(dev, wl["chips"])
    ms = sorted(win["ms"])
    tenths = [sum(c) / len(c) for c in np.array_split(
        np.asarray(win["ms"]), min(10, len(ms))) if len(c)]
    log(f"window: {win['attempted']} items in {win['seconds']:.3f} s (item "
        f"ms min {ms[0]:.2f} median {ms[len(ms) // 2]:.2f} max {ms[-1]:.2f};"
        f" mean of each tenth in order {' '.join(f'{t:.1f}' for t in tenths)}"
        f"); memory peak {info['memory_peak_bytes']} B")

    guard_ms = loop.guard_ms if traced and guarded else None
    kept = sampler.kept
    for rec in kept:
        if isinstance(rec["depth"], torch.Tensor):
            rec["depth"] = rec["depth"].cpu().numpy()
    del loop
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = check.judge(kept, arrays, cfg, dev)
    log(f"reference: {len(kept)} items in {time.perf_counter() - t_ref:.3f} s")
    ok, shown = check.verdict(numbers, lim)
    if control:
        ctl = check.judge(check.reference_frames(kept, arrays, cfg, dev),
                          arrays, cfg, dev)

    metrics = {}
    if traced:
        ctx = dict(cfg=cfg, workload=workload, trace=traced_sum,
                   guard_ms=guard_ms, item_ms=win["ms"])
        for m in bench.per_layer(workload):
            v = bench.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        st = loops.stats(win)
        for m in bench.end_to_end(workload):
            v = (setup_s if m["name"] == "setup_s"
                 else st[traffic["metrics"][m["name"]]])
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = (ok and win["failed"] == 0 and win["attempted"] > 0
               and program_flushed == 0)
    out = dict(correct=bool(correct), attempted=win["attempted"],
               failed=win["failed"], metrics=metrics, device=info)
    if traced:
        out["device"].update(busy_s=traced_sum["busy_s"],
                             window_s=traced_sum["window_s"])
        out["breakdown"] = dict(device_ops=traced_sum["device_ops"],
                                idle_gaps=traced_sum["idle_gaps"])
    if control:
        out["control"] = dict(numbers=ctl,
                              correct=check.verdict(ctl, lim)[0])
    out["checks"] = dict(shown, overflow_frames={
        "value": win["failed"] + program_flushed, "limit": 0})
    return out
