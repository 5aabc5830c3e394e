"""Production frame engine — sized caps + overflow recovery.

The counterpart of ``mt_renderer_tpu/render/engine.py``: the packed
single-layer frame and the peeled frame (``peel`` layers, ``peel_mode``
"split", "ml" or "multipass"), each bilinear or, with ``mipmap``,
trilinear, lit or not, on the binned raster (``backend="pallas"``), or
either frame on the scan backend (``backend="scan"``: no caps to size,
the unpacked frame); the frame comes back in the reference engine's
format (``packed``). ``FrameEngine`` owns the frame loop's wiring:

* lazy sizing at the first rendered view: ``auto_maxc`` for the binning
  cap; for the single-layer frame ``auto_tap_tiles`` for the compacted
  texture tap, for the "split" and "ml" peels ``measure_live_tap_tiles``
  (one run of the rasters and one device→host transfer; the multipass
  peel shades densely and takes no tap cap); a ``headroom`` factor over
  the measured need;
* a per-frame host-side cap guard (no device sync): the binning need is
  predicted exactly (``predict_bin_counts`` mirrors ``bin_chunks``) and
  the single-layer tap liveness bounded from above
  (``predict_live_rows``), so the engine grows a cap before a frame that
  would overflow it. When that row bound grows past the one seen at
  sizing, the peeled caps are measured again and grow element by
  element;
* overflow recovery as the backstop: every ``check_every`` frames the
  deferred overflow queue flushes (one device→host transfer; every
  frame for an ``interactive`` loop, 16 frames otherwise); any
  overflow re-sizes the affected cap at the current view (never below 2x
  the overflowed cap) and logs. This is the only recovery of the peeled
  caps from a spike in translucent depth, which has no cheap host bound.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..utils.profiling import span
from . import device
from . import raster as rs

logger = logging.getLogger("mt_renderer_tpu_torch.render")


class FrameEngine:
    def __init__(self, scene, batch, *, width: int, height: int,
                 backend: str = "pallas", mipmap: bool = False,
                 lighting: bool = False, peel: int = 0,
                 peel_mode: str = "split", headroom: float = 1.5,
                 check_every: int | None = None,
                 interactive: bool = False):
        if backend not in ("pallas", "scan"):
            raise ValueError(f"unknown backend {backend!r}")
        self.scene = scene
        self.backend = backend
        self.batch = batch
        self.width = width
        self.height = height
        self.mipmap = mipmap
        self.lighting = lighting
        self.peel = peel
        self.peel_mode = peel_mode
        self.headroom = headroom
        # an interactive loop reads every frame back anyway (the app
        # manager presents it), so a flush per frame costs no extra sync
        # and bounds the peeled tap caps' only recovery window to one
        # displayed frame; headless loops keep the 16-frame cadence
        if check_every is None:
            check_every = 1 if interactive else 16
        self.check_every = check_every
        self.maxc: int | None = None
        self.tap_tiles = None          # int, or the split peel's pair
        self.sized = False
        self.recoveries = 0            # cap bumps taken so far
        self._since_check = 0
        self._tap_bound = 0            # host row bound seen at sizing

    @property
    def packed(self) -> bool:
        """The frame format ``render`` returns, the reference engine's:
        the (H, W) int32 packed frame of the pallas backend, except for
        a peel with ``mipmap`` or ``peel_mode="multipass"``, whose frame
        is the (H, W, 4) uint8 frame, as is every scan frame."""
        if self.peel:
            return (self.backend == "pallas" and not self.mipmap
                    and self.peel_mode != "multipass")
        return self.backend == "pallas"

    @property
    def _tap_caps(self) -> bool:
        """Whether the frame compacts its texture taps to a measured cap
        (the multipass peel and the scan backend shade densely)."""
        return self.backend == "pallas" and not (
            self.peel and self.peel_mode == "multipass")

    def _predict(self, fn, view_proj, bone_mats, **kw):
        """A host predictor at this view; a palette on the device (the
        world's ``bone_mats_device``) is read back for it."""
        if isinstance(bone_mats, torch.Tensor):
            with span("predict.palette"):
                bone_mats = bone_mats.cpu().numpy()
        return fn(self.batch, np.asarray(view_proj), bone_mats,
                  width=self.width, height=self.height, **kw)

    def _measure_peel(self, view_proj, bone_mats):
        """The peeled frame's tap caps at this view (one device run)."""
        return device.measure_live_tap_tiles(
            self.scene, np.asarray(view_proj),
            bone_mats if self.batch.skinned else None, width=self.width,
            height=self.height, layers=self.peel, maxc=self.maxc,
            lighting=self.lighting, mode=self.peel_mode,
            margin=self.headroom)

    def size(self, view_proj, bone_mats=None) -> None:
        """Size the binning and compacted-tap caps for this view: host
        NumPy only, plus one device run on the "split" and "ml" peels.
        The scan backend has no caps."""
        self.sized = True
        if self.backend != "pallas":
            return
        self.maxc = self._predict(device.auto_maxc, view_proj, bone_mats,
                                  margin=self.headroom)
        self._tap_bound = self._predict(device.auto_tap_tiles, view_proj,
                                        bone_mats, margin=self.headroom)
        if not self._tap_caps:
            self.tap_tiles = None
        elif self.peel:
            self.tap_tiles = self._measure_peel(view_proj, bone_mats)
        else:
            self.tap_tiles = self._tap_bound
        logger.info("FrameEngine sized: maxc=%s tap_tiles=%s (%dx%d%s)",
                    self.maxc, self.tap_tiles, self.width, self.height,
                    f" peel{self.peel}/{self.peel_mode}" if self.peel
                    else "")

    def render(self, view_proj, bone_mats=None):
        """One production frame → (color, depth); color as ``packed``
        says."""
        if not self.sized:
            # drain counts queued by earlier renders so the first check
            # attributes overflow to this engine's frames only
            rs.flush_overflow_checks()
            self.size(view_proj, bone_mats)
        elif self.backend == "pallas":
            with span("engine.guard"):
                self._guard(view_proj, bone_mats)
        with span("engine.frame"):
            if self.peel:
                out = device.render_frame_peeled(
                    self.scene, view_proj, bone_mats, width=self.width,
                    height=self.height, layers=self.peel,
                    backend=self.backend, maxc=self.maxc,
                    mipmap=self.mipmap, lighting=self.lighting,
                    peel_mode=self.peel_mode, packed=self.packed,
                    tap_tiles=self.tap_tiles)
            else:
                out = device.render_frame(
                    self.scene, view_proj, bone_mats, width=self.width,
                    height=self.height, backend=self.backend,
                    maxc=self.maxc, mipmap=self.mipmap,
                    lighting=self.lighting, packed=self.packed,
                    tap_tiles=self.tap_tiles)
        self._since_check += 1
        if self._since_check >= self.check_every:
            with span("engine.check"):
                self.check(view_proj, bone_mats)
        return out

    def _guard(self, view_proj, bone_mats) -> None:
        """Pre-render host-side cap guard (no device sync, except the
        peel caps' re-measurement): grow the caps before a frame that
        would overflow them."""
        need = int(self._predict(device.predict_bin_counts, view_proj,
                                 bone_mats).max())
        if need > (self.maxc or 0):
            old = self.maxc
            self.maxc = self._predict(device.auto_maxc, view_proj,
                                      bone_mats, margin=self.headroom)
            self.recoveries += 1
            logger.info("FrameEngine guard: view needs %d candidate chunks "
                        "> maxc=%s — grew to %s before rendering",
                        need, old, self.maxc)
        bound = self._predict(device.auto_tap_tiles, view_proj, bone_mats,
                              margin=self.headroom)
        if bound <= self._tap_bound or not self._tap_caps:
            return
        self._tap_bound = bound
        old = self.tap_tiles
        if self.peel:
            fresh = self._measure_peel(view_proj, bone_mats)
            if isinstance(old, tuple):
                self.tap_tiles = tuple(max(o, n) for o, n in zip(old, fresh))
            else:
                self.tap_tiles = max(old or 0, fresh)
        else:
            self.tap_tiles = max(old or 0, bound)
        if self.tap_tiles != old:
            self.recoveries += 1
            logger.info("FrameEngine guard: tap row bound grew past the "
                        "sized caps — %s -> %s before rendering", old,
                        self.tap_tiles)

    def _grow(self, old, new):
        """Monotone cap growth, element by element for the split pair: at
        least the fresh measurement, at least 2x the overflowed cap (the
        overflow may have happened at an earlier view than the one just
        re-measured)."""
        if isinstance(old, tuple):
            return tuple(self._grow(o, n) for o, n in zip(old, new))
        return max(int(new), 2 * int(old))

    def check(self, view_proj=None, bone_mats=None) -> dict:
        """Flush the deferred overflow queue; on any overflow, re-size
        the affected cap at the current view and log. Returns the
        drained ``{what: (count, cap)}`` dict."""
        self._since_check = 0
        counts = rs.flush_overflow_counts()
        if not any(n > 0 for n, _ in counts.values()):
            return counts
        if view_proj is None or self.backend != "pallas":
            for what, (n, cap) in counts.items():
                rs._overflow_report(n, cap, what)
            return counts
        for what, (n, cap) in counts.items():
            if n <= 0:
                continue
            self.recoveries += 1
            if what.startswith("bin"):
                old = self.maxc
                self.maxc = self._grow(old, self._predict(
                    device.auto_maxc, view_proj, bone_mats,
                    margin=self.headroom))
                logger.warning(
                    "FrameEngine: bin overflow on %d tile-frame(s) at "
                    "maxc=%s — recovered to maxc=%s", n, old, self.maxc)
            else:
                old = self.tap_tiles
                if self.peel:
                    need = self._measure_peel(view_proj, bone_mats)
                else:
                    need = self._predict(device.auto_tap_tiles, view_proj,
                                         bone_mats, margin=self.headroom)
                grown = self._grow(old, need) if old else need
                # a cap past "every row live" buys nothing
                pw, ph = device._padded(self.width, self.height)
                nrows = (pw // rs.TILE_W) * (ph // (device.SEG_PX
                                                    // rs.TILE_W))
                if isinstance(grown, tuple):
                    grown = (min(grown[0], nrows),
                             min(grown[1], nrows * self.peel))
                else:
                    grown = min(grown, nrows * max(self.peel, 1))
                self.tap_tiles = grown
                logger.warning(
                    "FrameEngine: tap overflow on %d row(s) at "
                    "tap_tiles=%s — recovered to %s", n, old, self.tap_tiles)
        return counts
