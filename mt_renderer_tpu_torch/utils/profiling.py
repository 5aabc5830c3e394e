"""Frame statistics and logging set-up.

The reference's only instrumentation is an unused per-frame ``Duration``
(renderer_app_manager.rs:162-165) and ``log``-crate tracing gated by
``RUST_LOG`` (SURVEY §5). Here:

* ``FrameStats`` — rolling fps / frame-time / Mtri / Mtexel counters,
  which the app manager pushes every frame;
* ``trace(...)`` — a context manager around ``torch.profiler``; the
  Chrome trace it writes opens in Perfetto (or ``chrome://tracing``) and
  shows the CUDA kernels (K1 under its ``__global__`` name, beside the
  ``mtr::raster_fwd_*`` op that launched it), the torch ops and the
  host↔device copies of each frame;
* ``stage_timer`` — wall-clock stage timing fenced on the devices of
  what the stage produced (device work is asynchronous: naive timing
  measures the enqueue), each stage a ``record_function`` range that a
  trace shows under its name;
* ``setup_logging`` — ``MTR_LOG`` env var as the ``RUST_LOG`` analog.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

import torch


def setup_logging(default: str = "WARNING") -> None:
    """Configure the package logger from ``MTR_LOG`` (e.g. DEBUG, INFO)."""
    level = os.environ.get("MTR_LOG", default).upper()
    logging.basicConfig(
        level=getattr(logging, level, logging.WARNING),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )


@dataclass
class FrameStats:
    """Rolling render statistics over the last ``window`` frames."""

    window: int = 120
    _times: deque = field(default_factory=deque)
    _tris: deque = field(default_factory=deque)
    _texels: deque = field(default_factory=deque)
    frames: int = 0

    def push(self, frame_time_s: float, triangles: int = 0,
             texels: int = 0) -> None:
        self.frames += 1
        for q, v in ((self._times, frame_time_s), (self._tris, triangles),
                     (self._texels, texels)):
            q.append(v)
            if len(q) > self.window:
                q.popleft()

    @property
    def fps(self) -> float:
        t = sum(self._times)
        return len(self._times) / t if t > 0 else 0.0

    @property
    def frame_time_ms(self) -> float:
        return (sum(self._times) / len(self._times) * 1e3
                if self._times else 0.0)

    @property
    def mtri_per_s(self) -> float:
        t = sum(self._times)
        return sum(self._tris) / t / 1e6 if t > 0 else 0.0

    @property
    def mtexel_per_s(self) -> float:
        t = sum(self._times)
        return sum(self._texels) / t / 1e6 if t > 0 else 0.0

    def summary(self) -> str:
        return (f"{self.fps:.1f} fps ({self.frame_time_ms:.2f} ms/frame), "
                f"{self.mtri_per_s:.1f} Mtri/s, "
                f"{self.mtexel_per_s:.1f} Mtexel/s over "
                f"{len(self._times)} frames")


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` trace of the block: CPU activity, plus CUDA
    activity when a card is visible. On exit it writes a Chrome trace to
    ``log_dir``/``TRACE_FILE`` (default ``log_dir``: ``mtr_trace`` in the
    temporary directory). Yields ``log_dir``."""
    log_dir = str(Path(tempfile.gettempdir()) / "mtr_trace"
                  if log_dir is None else log_dir)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / TRACE_FILE))


@contextlib.contextmanager
def stage_timer(results: dict, name: str):
    """Time a stage, fenced on its device work, and mark it as a
    ``record_function`` range named ``name``.

    Usage::

        times = {}
        with stage_timer(times, "raster") as fence:
            out = raster(...)
            fence(out)          # synchronised before the clock stops

    ``fence`` takes a tensor or a (nested) tuple, list or dict of them;
    on exit each CUDA device that holds a fenced tensor is synchronised
    before the clock stops. Seconds accumulate under ``results[name]``."""
    fenced = []

    def fence(x):
        fenced.append(x)
        return x

    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield fence
        devices = {t.device for t in _tensors(fenced)
                   if t.device.type == "cuda"}
        for dev in devices:
            torch.cuda.synchronize(dev)
    results[name] = results.get(name, 0.0) + time.perf_counter() - t0


def _tensors(x):
    """The tensors in ``x``: a tensor, or a nested tuple, list or dict."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
