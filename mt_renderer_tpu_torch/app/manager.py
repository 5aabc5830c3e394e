"""App framework — the frame driver.

The reference's ``RendererAppManager`` owns the winit event loop, the wgpu
device and the per-frame render/submit/present cycle
(``src/renderer_app_manager.rs:84-272``); apps implement a three-hook
trait (``setup`` / ``render`` / ``post_render``,
renderer_app_manager.rs:14-32).

Here the manager drives an app whose ``render`` returns a frame tensor on
its device; the "swapchain present" is a host readback handed to a
frontend (PNG file, in-memory list, or a user callback). No OS window
exists on a headless host, so the interactive path takes scripted input
events instead of a live event pump — the camera/input math is
identical.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from .camera import Camera
from .input_state import InputState


class RendererApp:
    """Subclass hook points (mirrors the reference trait)."""

    def setup(self, manager: "RendererAppManager") -> None:
        raise NotImplementedError

    def render(self, manager: "RendererAppManager"):
        """Return the frame as (H, W, 4) uint8, or as the production
        packed format — (H, W) int32 holding the RGBA8 bits
        (``render_frame(packed=True)``; the manager unpacks at the host
        boundary). Tensors on any device, or NumPy arrays."""
        raise NotImplementedError

    def post_render(self, manager: "RendererAppManager") -> None:
        pass


def _to_rgba(frame) -> np.ndarray:
    """Host-side frame normalization: a packed (H, W) 32-bit frame →
    (H, W, 4) u8 view (one device→host copy); anything else is read back
    as it is."""
    if isinstance(frame, torch.Tensor):
        frame = frame.cpu().numpy()
    a = np.asarray(frame)
    if a.ndim == 2 and a.dtype in (np.int32, np.uint32):
        from ..render.device import unpack_rgba

        return unpack_rgba(a)
    return a


class RendererAppManager:
    def __init__(self, app: RendererApp, width: int = 512, height: int = 512,
                 camera: Camera | None = None):
        self.app = app
        self.width = width
        self.height = height
        self.camera = camera or Camera(position=[0.0, 0.0, 4.0])
        self.camera.aspect = width / height
        self.input = InputState()
        self.frame_time = 0.0          # seconds, last frame (rs:64-66)
        self.frame_index = 0
        self._last = None

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def run_frame(self):
        """One render cycle: render → input.next_frame → post_render."""
        t0 = time.perf_counter()
        frame = self.app.render(self)
        self.input.next_frame()
        self.app.post_render(self)
        self.frame_time = time.perf_counter() - t0
        self.frame_index += 1
        self._last = frame
        return frame

    def run_headless(self, frames: int = 1, out_path=None,
                     on_frame=None) -> np.ndarray:
        """Run ``setup`` then ``frames`` render cycles.

        ``out_path``: write the last frame (or every frame if the path
        contains ``{i}``) as PNG. ``on_frame(i, frame)``: optional hook.
        Returns the last frame as a NumPy array.
        """
        self.app.setup(self)
        last = None
        for i in range(frames):
            frame = _to_rgba(self.run_frame())
            if on_frame is not None:
                on_frame(i, frame)
            if out_path is not None and "{i}" in str(out_path):
                self._write(str(out_path).format(i=i), frame)
            last = frame
        self._flush_overflow()
        if out_path is not None and "{i}" not in str(out_path):
            self._write(out_path, last)
        return last

    @staticmethod
    def _flush_overflow() -> None:
        """Check queued bin-overflow counts at frame-loop exit (one
        device→host transfer; see raster.queue_overflow_check)."""
        from ..render.raster import flush_overflow_checks

        flush_overflow_checks()

    # -- interactive session (scripted event pump) -----------------------
    #
    # The reference's winit dispatch (renderer_app_manager.rs:215-269)
    # becomes a scripted event stream: each frame gets a list of events
    # that route into InputState exactly as the window loop would, then
    # the normal render cycle runs (apps call camera.update/fly from
    # their render hook, like modelviewer.rs:212-215).

    def dispatch_event(self, event) -> None:
        """One event: ("key_down"|"key_up", Key|"W") or ("mouse", dx, dy)."""
        from .input_state import Key

        kind = event[0]
        if kind in ("key_down", "key_up"):
            key = event[1]
            if isinstance(key, str):
                key = Key[key.upper()]
            if kind == "key_down":
                self.input.set_key(key)
            else:
                self.input.unset_key(key)
        elif kind == "mouse":
            self.input.add_mouse_movement(float(event[1]), float(event[2]))
        else:
            raise ValueError(f"unknown event {event!r}")

    def run_interactive(self, event_frames, out_path=None,
                        on_frame=None) -> np.ndarray:
        """Run ``setup`` then one render cycle per entry of
        ``event_frames`` (a list of per-frame event lists), dispatching
        each frame's events first. Returns the last frame."""
        self.app.setup(self)
        last = None
        for i, events in enumerate(event_frames):
            for ev in events:
                self.dispatch_event(ev)
            frame = _to_rgba(self.run_frame())
            if on_frame is not None:
                on_frame(i, frame)
            if out_path is not None and "{i}" in str(out_path):
                self._write(str(out_path).format(i=i), frame)
            last = frame
        self._flush_overflow()
        if out_path is not None and last is not None and "{i}" not in str(out_path):
            self._write(out_path, last)
        return last

    @staticmethod
    def _write(path, frame: np.ndarray) -> None:
        from ..utils.png import write_png

        Path(path).parent.mkdir(parents=True, exist_ok=True)
        write_png(path, frame)
