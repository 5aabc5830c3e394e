"""K1's share of its roofline: its least time, counted from a cell's
own sizes, over its device time a frame (the profiler's
``raster_fwd_kernel`` intervals over the items of the traced window).

K1 (``csrc/raster_fwd.cu``, the kernel ``raster_fwd_kernel``) must at
least read each triangle's setup column once (``setup_rows`` f32 rows)
and write each pixel's epilogue planes once (``planes`` f32 planes), and
cull each triangle against at least one warp's pixel block (12 f32
operations a test). The least time is the larger of those bytes over
3.35 TB/s and those operations over 67 TFLOP/s (one H100 SXM at 700 W,
dense f32 outside the tensor cores).

The count reads only the configuration: the triangle count, the frame
size and the epilogue's shape. It never reads the program's binning cap
(``maxc``), its chunk lists or its tap caps, which a later change to the
program may move: a yardstick made from them would move with them.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
OPS_PER_CULL = 12
KERNELS = ("raster_fwd_kernel",)     # K1's names in the profiler


def count(cfg: dict) -> dict:
    """{"bytes", "ops", "least_s", "bound"} of one frame's K1."""
    k1 = cfg["k1"]
    tris = cfg["triangles"]
    nbytes = 4 * (tris * k1["setup_rows"]
                  + cfg["width"] * cfg["height"] * k1["planes"])
    ops = OPS_PER_CULL * tris
    by_bytes, by_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return dict(bytes=nbytes, ops=ops, least_s=max(by_bytes, by_ops),
                bound="bytes" if by_bytes >= by_ops else "operations")


def read(ctx: dict) -> float | None:
    """K1's least time over its device time a frame, in percent, or None
    where the trace holds no K1 kernel."""
    tr = ctx["trace"]
    k1_s = sum(s for name, s in tr["kernel_s"].items()
               if any(k in name for k in KERNELS))
    if k1_s <= 0 or not tr["items"]:
        return None
    return 100.0 * count(ctx["cfg"])["least_s"] / (k1_s / tr["items"])
