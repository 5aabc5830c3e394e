"""The general traffic generator and the timed window.

A traffic mix is a data file, ``portbench/traffic/<mix>.json``, read
here. Its keys:

* ``loop``: ``"engine"`` (the viewer's ``FrameEngine(interactive=True)``
  loop, its overflow queue flushed every frame) or
  ``"artifact"`` (one client against the exported, saved and loaded
  render step);
* ``yaw``: ``{"walk": [lo, hi]}`` turns the scene by a step drawn
  uniformly from [lo, hi] degrees a frame, ``{"uniform": [lo, hi]}``
  draws every item's yaw afresh;
* ``time``: ``{"step_s": dt}`` advances the animation by dt a frame,
  ``{"uniform_s": [lo, hi]}`` draws it afresh;
* ``palette``: ``"program"`` (the program poses the skeleton, as a
  viewer does) or ``"client"`` (the benchmark sends the palette);
* ``warmup``: items run before the window (sizing, first launches);
* ``sample``: items of the window kept for the correctness check (a
  reservoir drawn from the seed);
* ``trace_seconds``: the window of a ``--trace 1`` run, at most
  ``--seconds``;
* ``metrics``: end-to-end name → ``"mean_ms"`` (the window over the
  items completed in it) or ``"p95_ms"`` (the 95th percentile of every
  item's time).

Both loops are closed: one viewer or client, each item sent when the one
before is on the host. An item is timed on the host clock from its
inputs to its frame on the host.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from . import program, views


class Inputs:
    """Each item's (yaw degrees, animation time seconds), from the seed."""

    def __init__(self, traffic: dict, seed: int):
        self.rng = np.random.default_rng([seed, 0x5EED])
        self.yaw_law, self.time_law = traffic["yaw"], traffic["time"]
        self.yaw, self.t = 0.0, 0.0

    def next(self) -> tuple[float, float]:
        r = self.rng
        if "walk" in self.yaw_law:
            self.yaw = (self.yaw + r.uniform(*self.yaw_law["walk"])) % 360.0
        else:
            self.yaw = float(r.uniform(*self.yaw_law["uniform"]))
        if "step_s" in self.time_law:
            self.t += self.time_law["step_s"]
        else:
            self.t = float(r.uniform(*self.time_law["uniform_s"]))
        return self.yaw, self.t


class Sampler:
    """A uniform reservoir of ``k`` items of the window, drawn from the
    seed: each keeps its inputs and the program's outputs."""

    def __init__(self, k: int, seed: int):
        self.k, self.n, self.kept = k, 0, []
        self.rng = np.random.default_rng([seed, 0x5A3])

    def offer(self, item: dict) -> None:
        self.n += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
            return
        j = int(self.rng.integers(0, self.n))
        if j < self.k:
            self.kept[j] = item


def _span(name: str, on: bool):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class Loop:
    """One cell's system under test and its per-item step."""

    def __init__(self, cfg: dict, traffic: dict, arrays, device, seed: int):
        self.cfg, self.traffic, self.arrays = cfg, traffic, arrays
        self.device = torch.device(device)
        self.inputs = Inputs(traffic, seed)
        self.batch, self.scene = program.upload(arrays, cfg, self.device)
        self.engine = self.artifact = None
        self.artifact_bytes = 0
        if traffic["loop"] == "engine":
            self.engine = program.frame_engine(self.scene, self.batch, cfg)
            self._over = [0]
            check = self.engine.check

            def counted(*a, **k):     # the overflow the flush reports
                counts = check(*a, **k)
                self._over[0] += sum(n for n, _ in counts.values())
                return counts

            self.engine.check = counted
            size = self.engine.size

            def sized(*a, **k):       # the engine's lazy sizing, timed
                t0 = time.perf_counter()
                out = size(*a, **k)
                self.size_s = time.perf_counter() - t0
                return out

            self.engine.size = sized
        elif traffic["loop"] == "artifact":
            self.artifact, self.artifact_bytes = program.served_artifact(
                self.scene, cfg)
        else:
            raise ValueError(f"unknown loop {traffic['loop']!r}")
        self.program_palette = (program.ProgramPalette(arrays, self.device)
                                if traffic["palette"] == "program" else None)
        self.spans = False
        self.guard_ms: list = []
        self.size_s = 0.0

    def trace_guard(self) -> bool:
        """Time the engine's host cap guard per frame (traced runs only);
        False where the program has no such method."""
        guard = getattr(self.engine, "_guard", None)
        if guard is None:
            return False

        def timed(*a, **k):
            t0 = time.perf_counter()
            with torch.profiler.record_function("guard"):
                out = guard(*a, **k)
            self.guard_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        self.engine._guard = timed
        return True

    def client_palette(self, t: float) -> np.ndarray:
        from .reference import palette

        return palette(self.arrays.animation, t).astype(np.float32)

    def step(self) -> dict:
        """One item → its record (inputs, latency, outputs)."""
        cfg, on = self.cfg, self.spans
        t0 = time.perf_counter()
        with _span("inputs", on):
            yaw, t = self.inputs.next()
            vp = views.view_proj(cfg["camera"], cfg["width"], cfg["height"],
                                 yaw)
            pal = (self.program_palette(t) if self.program_palette
                   else self.client_palette(t))
        with _span("render", on):
            if self.engine is not None:
                self._over[0] = 0
                color, depth = self.engine.render(vp, pal)
            else:
                color, depth = self.artifact(self.scene, vp, pal)
        with _span("readback", on):
            host = program.packed_rgba(color.cpu().numpy(), cfg["height"],
                                       cfg["width"])
        dt = time.perf_counter() - t0
        over = self._over[0] if self.engine is not None else 0
        return dict(yaw=yaw, t=t, vp=vp, ms=dt * 1e3, color=host,
                    depth=depth, overflow=over)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def window(loop: Loop, seconds: float, sampler: Sampler) -> dict:
    """Run items until ``seconds`` have passed → the window's record."""
    ms, failed = [], 0
    t0 = time.perf_counter()
    while True:
        rec = loop.step()
        ms.append(rec["ms"])
        failed += rec["overflow"] > 0
        sampler.offer(rec)
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    if loop.engine is None:
        # the served artifact queues its counts; drained once, after
        over = program.flush_overflow()
        failed = min(len(ms), over) if over else 0
    return dict(ms=ms, seconds=elapsed, attempted=len(ms), failed=failed)


def stats(win: dict) -> dict:
    """The window's end-to-end statistics by kind."""
    ms = np.asarray(win["ms"], np.float64)
    return {"mean_ms": win["seconds"] * 1e3 / len(ms),
            "p95_ms": float(np.percentile(ms, 95))}
