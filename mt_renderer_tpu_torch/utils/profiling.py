"""Frame statistics and logging set-up.

The reference's only instrumentation is an unused per-frame ``Duration``
(renderer_app_manager.rs:162-165) and ``log``-crate tracing gated by
``RUST_LOG`` (SURVEY §5). Here:

* ``FrameStats`` — rolling fps / frame-time / Mtri / Mtexel counters,
  which the app manager pushes every frame;
* ``setup_logging`` — ``MTR_LOG`` env var as the ``RUST_LOG`` analog.

The JAX package's ``trace`` and ``stage_timer`` (its profiler and fenced
stage timing) are not here: their counterparts, ``torch.profiler`` with
NVTX ranges, are ROADMAP Queue 1 item 17.
"""

from __future__ import annotations

import logging
import os
from collections import deque
from dataclasses import dataclass, field


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
