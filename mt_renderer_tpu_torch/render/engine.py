"""Production frame engine — sized caps + overflow recovery.

The counterpart of ``mt_renderer_tpu/render/engine.py``: the packed
single-layer frame and the peeled frame (``peel`` layers, ``peel_mode``
"split", "ml" or "multipass"), each bilinear or, with ``mipmap``,
trilinear, lit or not, on the binned raster (``backend="pallas"``), or
either frame on the scan backend (``backend="scan"``: no caps to size,
the unpacked frame); the frame comes back in the reference engine's
format (``packed``). ``FrameEngine`` owns the frame loop's wiring:

* lazy sizing at the first rendered view: the binning cap and, for the
  single-layer frame, the compacted texture tap's cap from the two
  counts of ``device.guard_counts``; for the "split" and "ml" peels
  the tap caps from ``measure_live_tap_tiles`` (one run of the rasters;
  the multipass peel shades densely and takes no tap cap); a
  ``headroom`` factor over the need, rounded up to a multiple of 8;
* a per-frame cap guard on the scene's device: ``guard_counts`` counts
  the frame's bin need exactly (``bin_chunks``' uncapped count on the
  frame's own group boxes) and bounds the single-layer tap liveness
  from above, and the engine reads both in one device→host transfer a
  frame, then grows a cap before a frame that would overflow it. When
  the row bound grows past the one seen at sizing, the peeled caps are
  measured again and grow element by element;
* overflow recovery as the backstop: every ``check_every`` frames the
  deferred overflow queue flushes (one device→host transfer; every
  frame for an ``interactive`` loop, 16 frames otherwise); any
  overflow re-sizes the affected cap at the current view (never below 2x
  the overflowed cap) and logs. This is the only recovery of the peeled
  caps from a spike in translucent depth, which the row bound does not
  see.

The host predictors (``device.auto_maxc``, ``auto_tap_tiles``) are not on
this path: they serve the band split, the verify legs and the tools.
"""

from __future__ import annotations

import logging
import math

import numpy as np

from ..utils.profiling import span
from . import device
from . import raster as rs

logger = logging.getLogger("mt_renderer_tpu_torch.render")


def _cap(count: int, margin: float, hi: int | None = None) -> int:
    """A cap over a measured ``count``: ``count`` x ``margin``, rounded
    up to a multiple of 8, at least 8 and at most ``hi``."""
    cap = max(8, -(-math.ceil(count * margin) // 8) * 8)
    return cap if hi is None else min(cap, hi)


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
        self._tap_bound = 0            # largest tap row cap counted yet
        self._rows = device._seg_rows_of(*device._padded(width, height))

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

    def _caps(self, view_proj, bone_mats) -> tuple[int, int, int]:
        """(bin need, binning cap, tap row cap) at this view: the two
        counts of ``device.guard_counts``, read back in one transfer,
        with the engine's headroom over each."""
        need, live = device.guard_counts(
            self.scene, view_proj, bone_mats, width=self.width,
            height=self.height).tolist()
        return (need, _cap(need, self.headroom),
                _cap(live, self.headroom, self._rows))

    def _measure_peel(self, view_proj, bone_mats):
        """The peeled frame's tap caps at this view (one device run)."""
        return device.measure_live_tap_tiles(
            self.scene, np.asarray(view_proj),
            bone_mats if self.batch.skinned else None, width=self.width,
            height=self.height, layers=self.peel, maxc=self.maxc,
            lighting=self.lighting, mode=self.peel_mode,
            margin=self.headroom)

    def size(self, view_proj, bone_mats=None) -> None:
        """Size the binning and compacted-tap caps for this view: the
        guard's counts, plus one run of the rasters on the "split" and
        "ml" peels. The scan backend has no caps."""
        self.sized = True
        if self.backend != "pallas":
            return
        _, self.maxc, self._tap_bound = self._caps(view_proj, bone_mats)
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
        """Pre-render cap guard: count this view's needs on the device,
        read them back once, and grow the caps before a frame that would
        overflow them (the peeled caps by a fresh measurement, when the
        row bound grew). ``guard.grow`` opens for each growth step."""
        with span("guard.count"):
            need, maxc, bound = self._caps(view_proj, bone_mats)
        if need > (self.maxc or 0):
            with span("guard.grow"):
                old, self.maxc = self.maxc, maxc
                self.recoveries += 1
                logger.info("FrameEngine guard: view needs %d candidate "
                            "chunks > maxc=%s — grew to %s before "
                            "rendering", need, old, self.maxc)
        if bound <= self._tap_bound or not self._tap_caps:
            return
        with span("guard.grow"):
            self._tap_bound = bound
            old = self.tap_tiles
            if self.peel:
                fresh = self._measure_peel(view_proj, bone_mats)
                if isinstance(old, tuple):
                    self.tap_tiles = tuple(max(o, n)
                                           for o, n in zip(old, fresh))
                else:
                    self.tap_tiles = max(old or 0, fresh)
            else:
                self.tap_tiles = max(old or 0, bound)
            if self.tap_tiles != old:
                self.recoveries += 1
                logger.info("FrameEngine guard: tap row bound grew past "
                            "the sized caps — %s -> %s before rendering",
                            old, self.tap_tiles)

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
        _, maxc, taps = self._caps(view_proj, bone_mats)
        for what, (n, cap) in counts.items():
            if n <= 0:
                continue
            self.recoveries += 1
            if what.startswith("bin"):
                old = self.maxc
                self.maxc = self._grow(old, maxc)
                logger.warning(
                    "FrameEngine: bin overflow on %d tile-frame(s) at "
                    "maxc=%s — recovered to maxc=%s", n, old, self.maxc)
            else:
                old = self.tap_tiles
                need = (self._measure_peel(view_proj, bone_mats)
                        if self.peel else taps)
                grown = self._grow(old, need) if old else need
                # a cap past "every row live" buys nothing
                if isinstance(grown, tuple):
                    grown = (min(grown[0], self._rows),
                             min(grown[1], self._rows * self.peel))
                else:
                    grown = min(grown, self._rows * max(self.peel, 1))
                self.tap_tiles = grown
                logger.warning(
                    "FrameEngine: tap overflow on %d row(s) at "
                    "tap_tiles=%s — recovered to %s", n, old, self.tap_tiles)
        return counts
