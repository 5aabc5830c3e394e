"""Binned tile raster: binning, the raster kernels K1 and K2, K1's
speed-of-light probe K3, the overflow queue.

The counterpart of ``mt_renderer_tpu/render/pallas_raster.py``: the
single-layer raster K1 (its tap, mtap and plain-attributes epilogues,
with or without the multipass peel's ``zlow`` exclusion) and the
multi-layer (order-independent transparency) raster K2 on the tap and
mtap paths; and of
``tools/bench/raster_roofline.py::_micro``, the probe K3 that runs K1's
group body on one resident chunk. It keeps the reference's geometry
(16x128-px tiles, 384-triangle chunks, 32-triangle culling groups), so
binning compares bit for bit with the JAX package's.

Per-triangle setup arrives as one column-major ``(ncol, Tp)`` f32 matrix
(``device.setup_packed_cols``): rows 0-14 are the raster columns

    0:3 ea   3:6 eb   6:9 ec   9:12 edge bias   12:15 z plane

and rows 15-32 the 18 coefficient columns the epilogues read

    15:18 u/w plane   18:21 v/w plane   21:24 1/w plane   24 tex
    25:29 C rgba      29:31 mip-0 pool offset hi/lo      31 th   32 tw

and, in the lit matrix, rows 33-41 the nx/w, ny/w, nz/w planes (27
coefficient columns).

Chunk ``c`` is triangles ``[c*CT, (c+1)*CT)`` and its group ``g`` is
triangles ``[c*CT + g*KG, +KG)``, so a triangle's global id is its
column index.

``raster_fwd``, ``raster_fwd_ml`` and ``raster_micro`` dispatch on the
tensors' device: a CPU tensor runs the plain PyTorch version
(``raster_fwd_reference``, ``raster_fwd_ml_reference``,
``raster_micro_reference``); a CUDA tensor launches the hand-written
kernel (``csrc/raster_fwd.cu``, ``csrc/raster_fwd_ml.cu``,
``csrc/raster_micro.cu``) or raises. ``raster_fwd`` dispatches through
the ``torch.library`` custom ops ``mtr::raster_fwd_tap``,
``mtr::raster_fwd_mtap`` and ``mtr::raster_fwd_attrs`` (``K1_OPS``), so
that ``torch.export`` can trace a frame (``serving.export_render``).

K1, K2 and K3 run ``PARTS`` CTAs per tile, each with ``WARPS // PARTS``
warps of ``WARP_W`` x ``WARP_H`` pixels, and every warp culls each
group's triangles against its rectangle of pixel centers before it
evaluates them. ``warp_cull_reference`` is that cull's plain twin: the
tests hold it exact per edge and conservative against the per-pixel
test, and the roofline counts the surviving (triangle, warp) pairs with
it.
"""

from __future__ import annotations

import ctypes
import logging
import os
import warnings

import torch

from .. import _build

logger = logging.getLogger("mt_renderer_tpu_torch.render")

TILE_H = 16
TILE_W = 128
P = TILE_H * TILE_W      # flattened pixels per tile
CT = 384                 # triangles per chunk
KG = 32                  # triangles per culling group
G = CT // KG             # culling groups per chunk (12): ascending g is
                         # ascending triangle index
MAXC_DEFAULT = 256       # binning cap: candidate chunks per tile
REJECT = 3.0e38          # edge bias that is never reached: always outside
N_RAST = 15              # raster columns
N_COEF = 18              # coefficient columns after the raster columns
N_COEF_LIT = 27          # ... of the lit matrix: + the normal planes
ATTRS_TAP = 6            # tap epilogue output planes: fx, fy, C rgba
ATTRS_MTAP = 17          # mtap epilogue output planes: u, v, tex, off
                         # hi/lo, th, tw, C rgba, then the winner's U/V/Q
                         # plane gradients over Q [U_x, U_y, V_x, V_y,
                         # Q_x, Q_y], the analytic LOD's inputs
ATTRS_FWD = 18           # attrs epilogue output planes: u/w, v/w, 1/w, tex,
                         # C rgba, off hi/lo, th, tw, then the raw U/V/Q
                         # plane gradients [U_x, U_y, V_x, V_y, Q_x, Q_y]
ATTRS_FWD_LIT = 21       # ... lit: [nx, ny, nz]/w after tw
TEX_ROW = N_RAST + 9     # tex column: an integer value marks an opaque row
MAX_LAYERS = 8           # K2 keeps 2..MAX_LAYERS fragments per pixel
MODES = ("tap", "mtap", "attrs")   # K1's epilogues (K2 runs the first two)
ML_MODES = MODES[:2]
PARTS = 4                # K1's and K3's CTAs per tile: 16x32 px each
PART_W = TILE_W // PARTS
WARP_W, WARP_H = 32, 8   # a K1 warp's pixel block; a lane owns a column
WARPS = P // (WARP_W * WARP_H)   # K1 warps per tile, over its parts
# csrc/raster_group.cuh fixes the same layout; each library built from it
# (K1's, K2's, K3's) is held to this copy at its first use (_check_layout)
LAYOUT = (PARTS, WARP_W, WARP_H, 32 * WARPS // PARTS)
_LAYOUT_CHECKED: set = set()


# ------------------------------------------------------------------ binning


def bin_chunks(bbox, n_ty: int, n_tx: int, maxc: int, x0: int, y0: int):
    """Order-preserving per-tile chunk lists + per-group overlap masks.

    ``bbox`` = (xmin, xmax, ymin, ymax, zmin), each (C*G,) f32 at group
    granularity. Returns (lists (n_tiles, maxc) i32 with -1 padding,
    glists (n_tiles, maxc) i32 with bit g set iff group g of that chunk
    overlaps the tile, counts (n_tiles,) i32 capped at maxc,
    counts_true (n_tiles,) i32 uncapped).

    Candidate chunks come nearest first (by chunk min depth). The order
    does not change the image: exact-z ties resolve by global triangle
    id in the raster. Over the cap, the farthest chunks are dropped."""
    xmin, xmax, ymin, ymax, zmin = bbox
    dev = xmin.device
    c = xmin.shape[0] // G
    n_tiles = n_ty * n_tx
    ty0 = torch.arange(n_ty, dtype=torch.float32, device=dev) * TILE_H \
        + float(y0)
    tx0 = torch.arange(n_tx, dtype=torch.float32, device=dev) * TILE_W \
        + float(x0)
    ovy = (ymax[:, None] >= ty0) & (ymin[:, None] <= ty0 + TILE_H)
    ovx = (xmax[:, None] >= tx0) & (xmin[:, None] <= tx0 + TILE_W)
    ov_g = (ovy[:, :, None] & ovx[:, None, :]).reshape(c, G, n_tiles)
    bits = 1 << torch.arange(G, dtype=torch.int32, device=dev)
    gbit = (ov_g.to(torch.int32) * bits[None, :, None]).sum(
        1, dtype=torch.int32).T.contiguous()              # (tiles, C)
    ov = gbit > 0

    counts_true = ov.sum(1, dtype=torch.int32)
    counts = counts_true.clamp(max=maxc)
    # z-rank per chunk: perm[i] = chunk id of the i-th nearest chunk
    zmin_c = zmin.reshape(c, G).amin(1)
    perm = torch.argsort(zmin_c, stable=True).to(torch.int32)
    rank = torch.empty(c, dtype=torch.int32, device=dev)
    rank[perm.long()] = torch.arange(c, dtype=torch.int32, device=dev)
    # top-k over key = C - rank keeps the nearest chunks, nearest first;
    # positive keys are unique, zero keys (no overlap) mask to -1
    key = torch.where(ov, c - rank, 0)
    topk = torch.topk(key, maxc, dim=1).values
    lists = torch.where(topk > 0,
                        perm[(c - topk).clamp(max=c - 1).long()], -1)
    glists = torch.gather(gbit, 1, lists.clamp(min=0).long())
    glists = torch.where(lists >= 0, glists, 0)
    return lists, glists, counts, counts_true


def prebin(cols, bbox, x0: int, y0: int, *, width: int, height: int,
           maxc: int = MAXC_DEFAULT):
    """Bin a frame's triangles → (lists, glists, counts, n_over) for
    ``raster_fwd``. ``n_over`` is a device i32 scalar: tiles whose true
    candidate count exceeded the cap (queue it with
    ``queue_overflow_check``). ``maxc`` is capped at the chunk count."""
    maxc = min(maxc, cols.shape[1] // CT)
    lists, glists, counts, counts_true = bin_chunks(
        bbox, height // TILE_H, width // TILE_W, maxc, x0, y0)
    n_over = (counts_true > maxc).sum(dtype=torch.int32)
    return lists, glists, counts, n_over


# ------------------------------------------------------------ overflow queue

# A tile whose true candidate count exceeds ``maxc`` drops its farthest
# chunks, and a compacted tap over its cap loses texture. Frame wrappers
# queue the device counts here without a sync; they stay on the device
# (summed there every _COMPRESS entries) until ``flush_overflow_checks``,
# the only transfer. Any overflow bumps OVERFLOW_EVENTS and warns;
# MTR_STRICT_OVERFLOW=1 makes it fatal.
OVERFLOW_EVENTS = 0
_WHAT_BINS = "bin overflow: candidate chunks dropped triangles; raise " \
             "maxc (see device.auto_maxc)"
_PENDING: dict = {}       # what -> [device counts]
_PENDING_CAP: dict = {}   # what -> largest cap seen
_COMPRESS = 512


def _overflow_report(n: int, cap: int, what: str = _WHAT_BINS):
    global OVERFLOW_EVENTS
    if n > 0:
        OVERFLOW_EVENTS += 1
        msg = f"raster: {n} tile-frame(s) exceeded cap={cap} — {what}"
        logger.error(msg)
        if os.environ.get("MTR_STRICT_OVERFLOW"):
            raise RuntimeError(msg)
        warnings.warn(msg, RuntimeWarning)


def _sum_grouped(q) -> list:
    """Device-side partial sums of queued scalars, one per device."""
    groups: dict = {}
    for x in q:
        groups.setdefault(x.device, []).append(x)
    return [g[0] if len(g) == 1 else torch.stack(g).sum(dtype=torch.int64)
            for g in groups.values()]


def queue_overflow_check(n_over, maxc: int, what: str = _WHAT_BINS):
    """Queue a device scalar (count over a static cap) for host
    checking. No sync: the queue only sums on the device once it grows
    past _COMPRESS entries."""
    q = _PENDING.setdefault(what, [])
    q.append(n_over)
    _PENDING_CAP[what] = max(_PENDING_CAP.get(what, 0), int(maxc))
    if len(q) >= _COMPRESS:
        _PENDING[what] = _sum_grouped(q)


def flush_overflow_counts() -> dict:
    """Drain the queue and return ``{what: (total, cap)}`` without
    reporting (one device→host transfer per overflow kind and device).
    ``engine.FrameEngine`` reads the counts itself and resizes."""
    pending = {w: q for w, q in _PENDING.items() if q}
    _PENDING.clear()
    caps = _PENDING_CAP.copy()
    _PENDING_CAP.clear()
    return {what: (sum(int(part) for part in _sum_grouped(q)),
                   caps.get(what, 0))
            for what, q in pending.items()}


def flush_overflow_checks():
    """Check all queued overflow counts. Call at the end of a frame loop
    or periodically."""
    for what, (total, cap) in flush_overflow_counts().items():
        _overflow_report(total, cap, what)


# ------------------------------------------------------------ K1: raster


def _trunc_i32(x):
    """f32 → i32 toward zero, saturating, NaN → 0: the CUDA kernel's
    ``__float2int_rz``, so both versions agree on every input."""
    big = x >= 2147483648.0
    i = torch.where(big | x.isnan(), 0.0,
                    x.clamp(min=-2147483648.0)).to(torch.int32)
    return torch.where(big, 2147483647, i)


def _plane(a, i: int, px, py):
    """Plane ``i`` of the coefficients ``a`` at the pixel centers."""
    return a[i] * px + a[i + 1] * py + a[i + 2]


def _persp_inv(a, px, py, w_eps: float):
    """1 / (the 1/w plane), with |1/w| clamped below by ``w_eps``."""
    w1 = _plane(a, 6, px, py)
    return torch.reciprocal(torch.where(w1.abs() < w_eps, w_eps, w1))


def _lit_scale(a, px, py, inv, light):
    """Directional lambert factor 0.3 + 0.7 * max(n.l / max(|n|, 1e-6),
    0) from the winner's normal planes (coefficients 18..26) and the
    unit ``light`` (pallas_raster.py:448-458).

    The square root runs in f64 and rounds once to f32, which is the
    correctly rounded f32 root the kernels' ``sqrtf`` gives: PyTorch's
    vectorised f32 ``sqrt`` on the CPU is not correctly rounded, and
    where a thread's chunk ends it takes the scalar one, which is; near a
    normal that interpolates through zero an ulp of |n| shows in C."""
    nx = _plane(a, 18, px, py) * inv
    ny = _plane(a, 21, px, py) * inv
    nz = _plane(a, 24, px, py) * inv
    ln = torch.sqrt((nx * nx + ny * ny + nz * nz).to(torch.float64)).to(
        torch.float32).clamp(min=1e-6)
    ndl = ((light[0] * nx + light[1] * ny + light[2] * nz) / ln).clamp(
        min=0.0)
    return 0.3 + 0.7 * ndl


def _lit_color(a, px, py, inv, light) -> list:
    """C rgba, rgb scaled by the lambert factor when ``light`` is given;
    alpha stays unlit."""
    if light is None:
        return [a[10], a[11], a[12], a[13]]
    s = _lit_scale(a, px, py, inv, light)
    return [a[10] * s, a[11] * s, a[12] * s, a[13]]


def _mtap_epilogue(a, px, py, w_eps: float, light=None) -> list:
    """The winner's coefficients ``a`` (N_COEF or N_COEF_LIT, ...) → the
    17 mtap planes as a list: perspective u, v, tex, off hi/lo, th, tw,
    C rgba (lit when ``light`` is given) and the U/V/Q plane gradients
    divided by Q. Zero coefficients (uncovered pixels) give zero planes."""
    inv = _persp_inv(a, px, py, w_eps)
    return ([_plane(a, 0, px, py) * inv, _plane(a, 3, px, py) * inv,
             a[9], a[14], a[15], a[16], a[17]]
            + _lit_color(a, px, py, inv, light)
            + [a[0] * inv, a[1] * inv, a[3] * inv, a[4] * inv, a[6] * inv,
               a[7] * inv])


def _tap_epilogue(a, px, py, w_eps: float, light=None):
    """The winner's coefficients ``a`` (N_COEF or N_COEF_LIT, ...) →
    (tattrs (..., 6 planes) as a list [fx, fy, C rgba], tapidx i32): the
    bilinear tap address of the mip-0 quad-pool row, evaluated at the
    pixel centers; C rgb lit when ``light`` is given. Zero coefficients
    (uncovered pixels) give tapidx 0, fx = fy = 0 and C = 0, as in the
    reference."""
    inv = _persp_inv(a, px, py, w_eps)
    u = _plane(a, 0, px, py) * inv
    v = _plane(a, 3, px, py) * inv
    th = a[16]
    tw = a[17]
    x = u * tw - 0.5
    y = v * th - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = torch.where(x0f < 0, 0.0, x - x0f)
    fy = torch.where(y0f < 0, 0.0, y - y0f)
    wwi = _trunc_i32(tw)
    hhi = _trunc_i32(th)
    x0c = torch.minimum(_trunc_i32(x0f).clamp(min=0), (wwi - 1).clamp(min=0))
    y0c = torch.minimum(_trunc_i32(y0f).clamp(min=0), (hhi - 1).clamp(min=0))
    offi = _trunc_i32(a[14]) * 4096 + _trunc_i32(a[15])
    idx = offi + y0c * wwi + x0c
    tapidx = torch.where(a[9] >= 0.0, idx, -1)
    return [fx, fy] + _lit_color(a, px, py, inv, light), tapidx


def _attrs_epilogue(a, px, py, lit: bool) -> list:
    """The winner's coefficients ``a`` (N_COEF or N_COEF_LIT, ...) → the
    18 (21 lit) attrs planes as a list: the u/w, v/w and 1/w planes at
    the pixel centers, tex, C rgba, off hi/lo, th, tw as stored, the
    [nx, ny, nz]/w planes when ``lit``, then the raw U/V/Q plane
    gradients (pallas_raster.py:518-529). Zero coefficients give zero
    planes."""
    rows = [_plane(a, 0, px, py), _plane(a, 3, px, py),
            _plane(a, 6, px, py)] + [a[9 + i] for i in range(9)]
    if lit:
        rows += [_plane(a, 18, px, py), _plane(a, 21, px, py),
                 _plane(a, 24, px, py)]
    return rows + [a[0], a[1], a[3], a[4], a[6], a[7]]


def _n_coef(light) -> int:
    return N_COEF if light is None else N_COEF_LIT


def n_planes(mode: str, light=None) -> int:
    """Output planes of K1's ``mode`` epilogue (lit when ``light``)."""
    if mode == "tap":
        return ATTRS_TAP
    if mode == "mtap":
        return ATTRS_MTAP
    return ATTRS_FWD if light is None else ATTRS_FWD_LIT


def _check_raster_args(cols, lists, glists, counts, width, height,
                       n_coef: int = N_COEF):
    if width % TILE_W or height % TILE_H:
        raise ValueError(f"band {width}x{height} not tile-aligned "
                         f"({TILE_W}x{TILE_H})")
    n_tiles = (height // TILE_H) * (width // TILE_W)
    if (cols.dtype != torch.float32 or cols.dim() != 2
            or cols.shape[0] < N_RAST + n_coef or cols.shape[1] % CT):
        raise ValueError(f"cols must be f32 (>= {N_RAST + n_coef}, k*{CT}),"
                         f" got {cols.dtype} {tuple(cols.shape)}")
    for name, x, shape in (("lists", lists, (n_tiles, lists.shape[-1])),
                           ("glists", glists, (n_tiles, lists.shape[-1])),
                           ("counts", counts, (n_tiles,))):
        if x.dtype != torch.int32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be i32 {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != cols.device:
            raise ValueError(f"{name} on {x.device}, cols on {cols.device}")


def _check_fwd_args(cols, lists, glists, counts, width, height, mode,
                    light, zlow=None):
    """The raster kernels' shared checks: the epilogue mode, the light,
    the column matrix (33 rows, 42 lit), the binning and K1's ``zlow``
    (tile-major (n_tiles, 1, P) f32 on the columns' device)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: one of {MODES}")
    if light is not None and len(light) != 3:
        raise ValueError(f"light must be a unit 3-vector, got {light!r}")
    _check_raster_args(cols, lists, glists, counts, width, height,
                       _n_coef(light))
    if zlow is not None:
        shape = (counts.shape[0], 1, P)
        if zlow.dtype != torch.float32 or tuple(zlow.shape) != shape:
            raise ValueError(f"zlow must be f32 {shape}, got {zlow.dtype} "
                             f"{tuple(zlow.shape)}")
        if zlow.device != cols.device:
            raise ValueError(f"zlow on {zlow.device}, cols on {cols.device}")


def raster_fwd(cols, lists, glists, counts, origin, *, width: int,
               height: int, w_eps: float, mode: str = "tap", light=None,
               zlow=None):
    """Binned single-layer raster over a band of ``width`` x ``height``
    px (tile-aligned) whose top-left pixel is ``origin`` = (x0, y0),
    with the tap (``mode="tap"``), the mip-tap (``"mtap"``) or the
    plain-attributes (``"attrs"``) epilogue. ``light`` (a unit 3-tuple;
    the lit column matrix of ``device.setup_packed_cols(lighting=True)``)
    folds the lambert factor into C rgb for "tap" and "mtap"; "attrs"
    then emits the normal planes and leaves the lighting to the shade.
    ``zlow`` (tile-major (n_tiles, 1, P) f32; the multipass peel's
    exclusion) admits at a pixel only candidates with z > zlow: +inf
    admits nothing, -inf everything.

    Returns tile-major tensors: zb (n_tiles, 1, P) f32 with 1.0 where
    uncovered, ib (n_tiles, 1, P) i32 winner id or -1, then for "tap"
    tattrs (n_tiles, 6, P) f32 [fx, fy, C rgba] and tapidx (n_tiles, 1,
    P) i32 quad-pool row or -1 for untextured winners; for "mtap" mattrs
    (n_tiles, 17, P) f32 (see ATTRS_MTAP); for "attrs" attrs (n_tiles,
    18 or 21 lit, P) f32 (see ATTRS_FWD).

    Every call goes through the custom op ``mtr::raster_fwd_<mode>``
    (``K1_OPS``), which ``torch.export`` traces
    (``serving.export_render``). On a CPU tensor the op runs
    ``raster_fwd_reference``; on a CUDA tensor it launches
    ``csrc/raster_fwd.cu`` (counted in ``raster_fwd.launches``) or
    raises."""
    _check_fwd_args(cols, lists, glists, counts, width, height, mode, light,
                    zlow)
    if cols.device.type not in ("cpu", "cuda"):
        raise ValueError(f"raster_fwd runs on CPU or CUDA, not "
                         f"{cols.device}")
    return K1_OPS[mode](cols, lists, glists, counts,
                        [int(o) for o in origin], width, height,
                        float(w_eps),
                        None if light is None else [float(c) for c in light],
                        zlow)


raster_fwd.launches = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _F, _F, _F,
             _P, _P, _P, _P, _P, _P]
_ML_ARGS = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P, _I, _I,
            _F, _F, _F, _P, _P, _P, _P, _P]
_MICRO_ARGS = [_P, _I, _I, _I, _I, _P, _P, _P, _P]


def _check_layout(name: str) -> None:
    """Raise unless kernel ``name``'s library (K1's, K2's or K3's) was built
    with this module's CTA layout (LAYOUT); checked once per library."""
    if name in _LAYOUT_CHECKED:
        return
    out = (ctypes.c_int * 4)()
    _build.fn(name, "mtr_raster_layout",
              [ctypes.POINTER(ctypes.c_int)])(out)
    if tuple(out) != LAYOUT:
        raise RuntimeError(f"{name} was built with the layout (PARTS, "
                           f"WARP_W, WARP_H, threads) {tuple(out)}, this "
                           f"module has {LAYOUT}")
    _LAYOUT_CHECKED.add(name)


def _raster_fwd_cuda(cols, lists, glists, counts, origin, *, width,
                     height, w_eps, mode, light, zlow=None):
    _check_layout("raster_fwd")
    fn = _build.fn("raster_fwd", "mtr_raster_fwd", _FWD_ARGS)
    cols = cols.contiguous()
    if cols.data_ptr() % 16:          # the kernel stages 16-byte copies
        cols = cols.clone()
    lists = lists.contiguous()
    glists = glists.contiguous()
    counts = counts.contiguous()
    zlow = None if zlow is None else zlow.contiguous()
    n_tx = width // TILE_W
    n_tiles = (height // TILE_H) * n_tx
    dev = cols.device
    zb = torch.empty((n_tiles, 1, P), dtype=torch.float32, device=dev)
    ib = torch.empty((n_tiles, 1, P), dtype=torch.int32, device=dev)
    attrs = torch.empty((n_tiles, n_planes(mode, light), P),
                        dtype=torch.float32, device=dev)
    tapidx = (torch.empty((n_tiles, 1, P), dtype=torch.int32, device=dev)
              if mode == "tap" else None)
    lx, ly, lz = (0.0, 0.0, 0.0) if light is None else light
    x0, y0 = (int(o) for o in origin)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cols.data_ptr(), cols.shape[1], lists.data_ptr(),
                 glists.data_ptr(), counts.data_ptr(), n_tiles,
                 lists.shape[1], n_tx, x0, y0, w_eps, MODES.index(mode),
                 int(light is not None), lx, ly, lz,
                 None if zlow is None else zlow.data_ptr(), zb.data_ptr(),
                 ib.data_ptr(), attrs.data_ptr(),
                 None if tapidx is None else tapidx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"raster_fwd kernel launch failed: cudaError {err}")
    raster_fwd.launches += 1
    return (zb, ib, attrs, tapidx) if mode == "tap" else (zb, ib, attrs)


def _pixel_centers(width: int, height: int, origin, dev):
    """Tile-major pixel-center coordinates (px, py), each (n_tiles, P)
    f32, of a band whose top-left pixel is ``origin``."""
    n_tx = width // TILE_W
    n_tiles = (height // TILE_H) * n_tx
    x0, y0 = (int(o) for o in origin)
    t = torch.arange(n_tiles, device=dev)
    flat = torch.arange(P, device=dev)
    px0 = ((t % n_tx) * TILE_W + x0).to(torch.float32)
    py0 = ((t // n_tx) * TILE_H + y0).to(torch.float32)
    px = (flat % TILE_W).to(torch.float32)[None, :] + (px0 + 0.5)[:, None]
    py = (flat // TILE_W).to(torch.float32)[None, :] + (py0 + 0.5)[:, None]
    return px, py


def _raster_winners(cols, lists, glists, counts, px, py, zlow=None):
    """The single-layer raster's visibility pass, plain PyTorch → (zbuf
    (n_tiles, P) f32 with +inf where uncovered, win (n_tiles, P) i32 or
    -1). Batches over the tiles that are live at each (list slot, group)
    step; reads no chunk beyond a tile's ``counts`` and skips groups
    whose mask bit is clear. Per pixel it keeps the lexicographic minimum
    of (z, -global id) over candidates inside all three edges with
    0 <= z (and z > ``zlow``, (n_tiles, P), when given): each group's
    nearest (latest on ties) candidate replaces the running winner if
    nearer, or equally near with a larger id."""
    dev = cols.device
    n_tiles = counts.shape[0]
    zbuf = torch.full((n_tiles, P), float("inf"), device=dev)
    win = torch.full((n_tiles, P), -1, dtype=torch.int32, device=dev)
    kk = torch.arange(KG, dtype=torch.int32, device=dev)

    n_slots = int(counts.max()) if n_tiles else 0
    for s in range(n_slots):
        cid = lists[:, s]
        gm = glists[:, s]
        in_list = counts > s
        for g in range(G):
            act = torch.nonzero(in_list & (((gm >> g) & 1) != 0)).squeeze(1)
            if act.numel() == 0:
                continue
            ids = cid[act, None] * CT + g * KG + kk              # (A, KG)
            blk = cols[:N_RAST][:, ids.long()][..., None]     # (15, A, KG, 1)
            pxa = px[act][:, None, :]                         # (A, 1, P)
            pya = py[act][:, None, :]

            def edge_ok(i):
                e = blk[i] * pxa + blk[3 + i] * pya + blk[6 + i]
                return e > blk[9 + i]

            inside = edge_ok(0) & edge_ok(1) & edge_ok(2)
            z = blk[12] * pxa + blk[13] * pya + blk[14]        # (A, KG, P)
            zb_a = zbuf[act]
            wn_a = win[act]
            zok = inside & (z >= 0.0) & (z <= zb_a[:, None, :])
            if zlow is not None:
                zok &= z > zlow[act][:, None, :]
            zm = torch.where(zok, z, float("inf"))
            zmin = zm.amin(1)                                 # (A, P)
            winner_k = torch.where(zok & (zm == zmin[:, None, :]),
                                   kk[None, :, None], -1).amax(1)
            new_id = cid[act, None] * CT + g * KG + winner_k
            upd = torch.isfinite(zmin) & (
                (zmin < zb_a) | ((zmin == zb_a) & (new_id > wn_a)))
            zbuf[act] = torch.where(upd, zmin, zb_a)
            win[act] = torch.where(upd, new_id, wn_a)
    return zbuf, win


def raster_fwd_reference(cols, lists, glists, counts, origin, *,
                         width: int, height: int, w_eps: float,
                         mode: str = "tap", light=None, zlow=None):
    """Plain PyTorch version of ``raster_fwd``, same contract: the
    visibility pass of ``_raster_winners`` (with the ``zlow`` exclusion),
    then the winner's coefficient columns gathered by id (zero where
    uncovered) and the epilogue evaluated at the pixel centers."""
    _check_fwd_args(cols, lists, glists, counts, width, height, mode, light,
                    zlow)
    px, py = _pixel_centers(width, height, origin, cols.device)
    zbuf, win = _raster_winners(cols, lists, glists, counts, px, py,
                                None if zlow is None else zlow[:, 0, :])
    covered = win >= 0
    nc = _n_coef(light)
    coef = cols[N_RAST:N_RAST + nc][:, win.clamp(min=0).long()]
    coef = torch.where(covered, coef, 0.0)                # (nc, tiles, P)
    zb = torch.where(covered, zbuf, 1.0)[:, None, :]
    if mode == "mtap":
        return (zb, win[:, None, :],
                torch.stack(_mtap_epilogue(coef, px, py, w_eps, light), 1))
    if mode == "attrs":
        return (zb, win[:, None, :],
                torch.stack(_attrs_epilogue(coef, px, py, light is not None),
                            1))
    planes, tapidx = _tap_epilogue(coef, px, py, w_eps, light)
    return zb, win[:, None, :], torch.stack(planes, 1), tapidx[:, None, :]


# ------------------------------------------------------- K1 as a custom op

# K1's three epilogues as ``torch.library`` ops, so that ``torch.export``
# sees the raster as one node (its fake kernel gives the output shapes)
# and a loaded program dispatches to the same kernels as eager code: the
# plain version on the CPU, the hand kernel (and its launch count) on
# CUDA. The op names stand in a serialized program; a program that holds
# them loads only where this module is imported.
_K1_SCHEMA = ("(Tensor cols, Tensor lists, Tensor glists, Tensor counts, "
              "int[] origin, int width, int height, float w_eps, "
              "float[]? light, Tensor? zlow=None) -> ({})")


def _k1_kw(mode, width, height, w_eps, light, zlow) -> dict:
    return dict(width=width, height=height, w_eps=w_eps, mode=mode,
                light=None if light is None else tuple(light), zlow=zlow)


def _register_k1_op(mode: str):
    n_out = 4 if mode == "tap" else 3

    def cpu(cols, lists, glists, counts, origin, width, height, w_eps,
            light, zlow=None):
        return raster_fwd_reference(cols, lists, glists, counts, origin,
                                    **_k1_kw(mode, width, height, w_eps,
                                             light, zlow))

    def cuda(cols, lists, glists, counts, origin, width, height, w_eps,
             light, zlow=None):
        return _raster_fwd_cuda(cols, lists, glists, counts, origin,
                                **_k1_kw(mode, width, height, w_eps, light,
                                         zlow))

    def fake(cols, lists, glists, counts, origin, width, height, w_eps,
             light, zlow=None):
        n_tiles = (height // TILE_H) * (width // TILE_W)
        out = (cols.new_empty((n_tiles, 1, P)),
               cols.new_empty((n_tiles, 1, P), dtype=torch.int32),
               cols.new_empty((n_tiles, n_planes(mode, light), P)),
               cols.new_empty((n_tiles, 1, P), dtype=torch.int32))
        return out[:n_out]

    op = torch.library.custom_op(
        f"mtr::raster_fwd_{mode}", cpu, mutates_args=(),
        device_types="cpu",
        schema=_K1_SCHEMA.format(", ".join(["Tensor"] * n_out)))
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    return op


K1_OPS = {mode: _register_k1_op(mode) for mode in MODES}


# ------------------------------------------------ K1's cull: the plain twin


def _by_warp(x):
    """Tile-major per-pixel values (n_tiles, P) → (n_tiles, WARPS,
    WARP_W * WARP_H), grouped by K1's warps (``warp_pixel_centers``)."""
    return (x.reshape(x.shape[0], TILE_H // WARP_H, WARP_H, PARTS,
                      PART_W // WARP_W, WARP_W)
            .permute(0, 3, 1, 4, 2, 5)
            .reshape(x.shape[0], WARPS, WARP_H * WARP_W))


def warp_pixel_centers(width: int, height: int, origin, dev):
    """The pixel centers of K1's warps → (px, py), each (n_tiles, WARPS,
    WARP_W * WARP_H) f32. With n = WARPS // PARTS warps a part and m =
    PART_W // WARP_W of them across it, warp w of a tile is warp i = w %
    n of part w // n (whose PART_W columns start at PART_W * part); it
    covers the part's columns WARP_W * (i % m) + [0, WARP_W) and rows
    WARP_H * (i // m) + [0, WARP_H), as ``csrc/raster_group.cuh::
    warp_pixels`` maps them."""
    px, py = _pixel_centers(width, height, origin, dev)
    return _by_warp(px), _by_warp(py)


def _edge_may_pass(a, b, c, bias, x0, x1, y0, y1):
    """False only where no pixel center of the rectangle [x0, x1] x [y0,
    y1] (its corners pixel centers) passes a*x + b*y + c > bias: the
    value at the corner picked by the signs of a and b, rounded as the
    pixels round it, is their largest (each rounding is monotone). K1's
    cull, op for op (``csrc/raster_group.cuh::edge_may_pass``); a NaN
    corner never rejects."""
    m = a * torch.where(a >= 0.0, x1, x0) + b * torch.where(b >= 0.0, y1,
                                                            y0) + c
    return ~(m <= bias)


def warp_cull_reference(cols, lists, glists, counts, origin, *, width: int,
                        height: int):
    """Plain PyTorch twin of the per-warp edge cull of K1 and K2 on
    ``raster_fwd``'s (or ``raster_fwd_ml``'s) inputs → live (n_tiles,
    maxc, G, WARPS, KG) bool: True where triangle k of group g of the
    chunk in list slot s survives warp w's test (see
    ``warp_pixel_centers`` for the warps); False for slots at or past a
    tile's count and for groups whose mask bit is clear. K1 evaluates
    exactly the True entries, so ``live.sum()`` is the surviving
    (triangle, warp) pairs of a launch, and so does K2. A culled pair
    has no pixel inside all three edges, so it neither wins in K1 nor
    enters any layer in K2. Not on the frame path: the tests and the
    roofline's counts use it."""
    _check_raster_args(cols, lists, glists, counts, width, height, 0)
    dev = cols.device
    n_tiles, maxc = lists.shape
    px, py = warp_pixel_centers(width, height, origin, dev)
    x0, x1 = px.amin(-1)[:, None, :], px.amax(-1)[:, None, :]
    y0, y1 = py.amin(-1)[:, None, :], py.amax(-1)[:, None, :]
    live = torch.zeros((n_tiles, maxc, G, WARPS, KG), dtype=torch.bool,
                       device=dev)
    kk = torch.arange(CT, device=dev)
    gg = torch.arange(G, device=dev)
    for s in range(int(counts.max()) if n_tiles else 0):
        act = torch.nonzero(counts > s).squeeze(1)
        ids = lists[act, s, None].long() * CT + kk              # (A, CT)
        r = cols[:12][:, ids][..., None]                    # (12, A, CT, 1)
        rect = (x0[act], x1[act], y0[act], y1[act])           # (A, 1, WARPS)
        ok = (_edge_may_pass(r[0], r[3], r[6], r[9], *rect)
              & _edge_may_pass(r[1], r[4], r[7], r[10], *rect)
              & _edge_may_pass(r[2], r[5], r[8], r[11], *rect))
        gbit = ((glists[act, s, None] >> gg) & 1) != 0         # (A, G)
        live[act, s] = (ok.reshape(-1, G, KG, WARPS).transpose(2, 3)
                        & gbit[:, :, None, None])
    return live


# ------------------------------------------------------ K3: the probe


def blocks_per_sm(device) -> int:
    """CTAs of K1 (unlit tap, the headline's instantiation; PARTS of
    them per tile) that one SM of ``device`` holds at once."""
    _check_layout("raster_fwd")
    fn = _build.fn("raster_fwd", "mtr_raster_fwd_blocks_per_sm",
                   [ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return out.value


def _check_micro_args(chunk_cols, reps, n_coef, rows):
    if (chunk_cols.dtype != torch.float32 or chunk_cols.dim() != 2
            or chunk_cols.shape[0] < N_RAST + n_coef
            or chunk_cols.shape[1] < CT):
        raise ValueError(f"chunk_cols must be f32 (>= {N_RAST + n_coef}, "
                         f">= {CT}), got {chunk_cols.dtype} "
                         f"{tuple(chunk_cols.shape)}")
    if reps < 1 or n_coef < 0 or (rows is not None and rows < 1):
        raise ValueError(f"bad reps={reps}, n_coef={n_coef}, rows={rows}")


def card_rows(device) -> int:
    """The probe's rows that fill every SM of ``device`` at K1's
    occupancy: SMs x K1's CTAs per SM over the PARTS CTAs of a row."""
    return (torch.cuda.get_device_properties(device).multi_processor_count
            * blocks_per_sm(device) // PARTS)


def raster_micro(chunk_cols, reps: int, n_coef: int, rows: int | None = None):
    """K1's speed-of-light probe (the counterpart of
    ``tools/bench/raster_roofline.py::_micro``): K1's group body (the
    per-warp cull, then the survivors' evaluation) over one 16x128 tile
    with tile-local pixel centers, on the chunk whose setup columns are
    ``chunk_cols`` (column-major (>= 15 + n_coef, >= 384) f32, triangle
    k in column k), ``reps`` x 12 groups ungated, the loop index passed
    as the chunk id (ids are rep * 384 + k).

    Returns (z (rows, 1, P) f32 with +inf where uncovered, id (rows, 1,
    P) i32 or -1, coef (rows, n_coef, P) f32: the winner's first
    ``n_coef`` coefficient columns, zero where uncovered). On the card
    ``rows`` identical rows are computed, each by K1's PARTS CTAs
    (default ``card_rows``: every SM filled at K1's occupancy); a CPU
    tensor runs ``raster_micro_reference``, one row (``rows`` must be
    None or 1). A CUDA tensor launches ``csrc/raster_micro.cu`` (counted
    in ``raster_micro.launches``) or raises."""
    _check_micro_args(chunk_cols, reps, n_coef, rows)
    dev = chunk_cols.device
    if dev.type == "cpu":
        if rows not in (None, 1):
            raise ValueError("the plain probe computes one row")
        return raster_micro_reference(chunk_cols, reps, n_coef)
    if dev.type != "cuda":
        raise ValueError(f"raster_micro runs on CPU or CUDA, not {dev}")
    if rows is None:
        rows = card_rows(dev)
    _check_layout("raster_micro")
    fn = _build.fn("raster_micro", "mtr_raster_micro", _MICRO_ARGS)
    cols = chunk_cols.contiguous()
    z = torch.empty((rows, 1, P), dtype=torch.float32, device=dev)
    ids = torch.empty((rows, 1, P), dtype=torch.int32, device=dev)
    coef = torch.empty((rows, n_coef, P), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cols.data_ptr(), cols.shape[1], reps, n_coef, rows,
                 z.data_ptr(), ids.data_ptr(), coef.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"raster_micro kernel launch failed: cudaError "
                           f"{err}")
    raster_micro.launches += 1
    return z, ids, coef


raster_micro.launches = 0


def raster_micro_reference(chunk_cols, reps: int, n_coef: int):
    """Plain PyTorch version of ``raster_micro``, one row: K1's plain
    visibility pass over one tile at the origin whose chunk list is the
    chunk ``reps`` times over, as chunks 0..reps-1 of ``reps`` copies of
    its columns (so ids are rep * 384 + k), then the winner's columns
    gathered by id."""
    _check_micro_args(chunk_cols, reps, n_coef, None)
    dev = chunk_cols.device
    cols = chunk_cols[:N_RAST + n_coef, :CT].repeat(1, reps)
    lists = torch.arange(reps, dtype=torch.int32, device=dev)[None]
    glists = torch.full_like(lists, (1 << G) - 1)
    counts = torch.full((1,), reps, dtype=torch.int32, device=dev)
    px, py = _pixel_centers(TILE_W, TILE_H, (0, 0), dev)
    z, win = _raster_winners(cols, lists, glists, counts, px, py)
    covered = win >= 0
    coef = cols[N_RAST:][:, win.clamp(min=0).long()]
    coef = torch.where(covered, coef, 0.0).permute(1, 0, 2)
    return z[:, None, :], win[:, None, :], coef.contiguous()


# ------------------------------------------------------------ K2: raster ML


def _check_ml_args(cols, lists, glists, counts, width, height, layers, zhi,
                   mode, light):
    if mode not in ML_MODES:
        raise ValueError(f"unknown mode {mode!r}: K2 runs one of {ML_MODES}")
    _check_fwd_args(cols, lists, glists, counts, width, height, mode, light)
    if not 2 <= layers <= MAX_LAYERS:
        raise ValueError(f"layers={layers} out of range [2, {MAX_LAYERS}]")
    if zhi is not None:
        shape = (counts.shape[0], 1, P)
        if zhi.dtype != torch.float32 or tuple(zhi.shape) != shape:
            raise ValueError(f"zhi must be f32 {shape}, got {zhi.dtype} "
                             f"{tuple(zhi.shape)}")
        if zhi.device != cols.device:
            raise ValueError(f"zhi on {zhi.device}, cols on {cols.device}")


def raster_fwd_ml(cols, lists, glists, counts, origin, *, width: int,
                  height: int, layers: int, w_eps: float,
                  opaque_cull: bool, zhi=None, mode: str = "tap",
                  light=None):
    """Binned multi-layer (order-independent transparency) raster with
    the tap (``mode="tap"``) or mip-tap (``"mtap"``) epilogue per layer,
    over a band of ``width`` x ``height`` px (tile-aligned) whose
    top-left pixel is ``origin`` = (x0, y0). ``light`` (a unit 3-tuple;
    the lit column matrix) folds the lambert factor into each layer's C
    rgb, as in ``raster_fwd``.

    Per pixel it keeps the ``layers`` (2..8) nearest fragments, ordered
    by z ascending and then by global id descending on exact ties, among
    the candidates inside all three edges with 0 <= z <= ``zhi`` (a
    tile-major (n_tiles, 1, P) f32 depth horizon, when given; the split
    peel passes the opaque pass's z-buffer). ``opaque_cull`` also culls
    candidates behind the nearest opaque one (integer tex column) and
    invalidates kept entries strictly behind it: the reference's
    ``variant="full"``; without it, ``"nocull"``.

    Returns tile-major tensors, nearest layer first: zl (n_tiles, L, P)
    f32 with 1.0 where the id is < 0, il (n_tiles, L, P) i32 kept id or
    -1, then for "tap" tattrs (n_tiles, 6L, P) f32 with layer l's [fx,
    fy, C rgba] at rows 6l..6l+5 and tapidx (n_tiles, L, P) i32; for
    "mtap" mattrs (n_tiles, 17L, P) f32 with layer l's planes (see
    ATTRS_MTAP) at rows 17l..17l+16.

    A CPU tensor runs ``raster_fwd_ml_reference``. A CUDA tensor
    launches ``csrc/raster_fwd_ml.cu`` (counted in
    ``raster_fwd_ml.launches``) or raises."""
    _check_ml_args(cols, lists, glists, counts, width, height, layers, zhi,
                   mode, light)
    kw = dict(width=width, height=height, layers=layers, w_eps=w_eps,
              opaque_cull=opaque_cull, zhi=zhi, mode=mode, light=light)
    if cols.device.type == "cpu":
        return raster_fwd_ml_reference(cols, lists, glists, counts, origin,
                                       **kw)
    if cols.device.type != "cuda":
        raise ValueError(f"raster_fwd_ml runs on CPU or CUDA, not "
                         f"{cols.device}")
    return _raster_fwd_ml_cuda(cols, lists, glists, counts, origin, **kw)


raster_fwd_ml.launches = 0


def _raster_fwd_ml_cuda(cols, lists, glists, counts, origin, *, width,
                        height, layers, w_eps, opaque_cull, zhi, mode,
                        light):
    _check_layout("raster_fwd_ml")
    fn = _build.fn("raster_fwd_ml", "mtr_raster_fwd_ml", _ML_ARGS)
    cols = cols.contiguous()
    if cols.data_ptr() % 16:          # the kernel stages 16-byte copies
        cols = cols.clone()
    lists = lists.contiguous()
    glists = glists.contiguous()
    counts = counts.contiguous()
    zhi = None if zhi is None else zhi.contiguous()
    n_tx = width // TILE_W
    n_tiles = (height // TILE_H) * n_tx
    dev = cols.device
    n_planes = ATTRS_TAP if mode == "tap" else ATTRS_MTAP
    zl = torch.empty((n_tiles, layers, P), dtype=torch.float32, device=dev)
    il = torch.empty((n_tiles, layers, P), dtype=torch.int32, device=dev)
    attrs = torch.empty((n_tiles, layers * n_planes, P),
                        dtype=torch.float32, device=dev)
    tapidx = (torch.empty((n_tiles, layers, P), dtype=torch.int32,
                          device=dev) if mode == "tap" else None)
    lx, ly, lz = (0.0, 0.0, 0.0) if light is None else light
    x0, y0 = (int(o) for o in origin)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cols.data_ptr(), cols.shape[1], lists.data_ptr(),
                 glists.data_ptr(), counts.data_ptr(), n_tiles,
                 lists.shape[1], n_tx, x0, y0, w_eps, layers,
                 int(opaque_cull), None if zhi is None else zhi.data_ptr(),
                 MODES.index(mode), int(light is not None), lx, ly, lz,
                 zl.data_ptr(), il.data_ptr(), attrs.data_ptr(),
                 None if tapidx is None else tapidx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"raster_fwd_ml kernel launch failed: cudaError "
                           f"{err}")
    raster_fwd_ml.launches += 1
    return (zl, il, attrs, tapidx) if mode == "tap" else (zl, il, attrs)


def ml_blocks_per_sm(device, layers: int, opaque_cull: bool,
                     has_zhi: bool) -> int:
    """CTAs of K2's (layers, opaque_cull, zhi) instantiation (PARTS of
    them per tile) that one SM of ``device`` holds at once."""
    _check_layout("raster_fwd_ml")
    fn = _build.fn("raster_fwd_ml", "mtr_raster_fwd_ml_blocks_per_sm",
                   [_I, _I, _I, ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(layers, int(opaque_cull), int(has_zhi), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return out.value


def raster_fwd_ml_reference(cols, lists, glists, counts, origin, *,
                            width: int, height: int, layers: int,
                            w_eps: float, opaque_cull: bool, zhi=None,
                            mode: str = "tap", light=None):
    """Plain PyTorch version of ``raster_fwd_ml``, same contract, in the
    reference's per-group form. Batches over the tiles that are live at
    each (list slot, group) step. Each group culls its candidates against
    min(list's deepest z, ``zhi``, nearest opaque z so far), where the
    opaque z first takes in the group's own opaque candidates; then each
    pixel extracts the group's remaining candidates nearest first (ties:
    larger id first), up to ``layers`` of them, inserting each at the
    number of kept entries that precede it under (z asc, id desc). With
    ``opaque_cull``, kept entries strictly behind the final opaque z are
    invalidated. Coefficients are gathered by id, and each layer runs
    the single-layer raster's tap or mtap epilogue."""
    _check_ml_args(cols, lists, glists, counts, width, height, layers, zhi,
                   mode, light)
    dev = cols.device
    n_tiles = counts.shape[0]
    px, py = _pixel_centers(width, height, origin, dev)
    inf = float("inf")
    zl = torch.full((n_tiles, layers, P), inf, device=dev)
    il = torch.full((n_tiles, layers, P), -1, dtype=torch.int32, device=dev)
    zop = torch.full((n_tiles, P), inf, device=dev)
    kk = torch.arange(KG, dtype=torch.int32, device=dev)
    li = torch.arange(layers, device=dev)[None, :, None]

    n_slots = int(counts.max()) if n_tiles else 0
    for s in range(n_slots):
        cid = lists[:, s]
        gm = glists[:, s]
        in_list = counts > s
        for g in range(G):
            act = torch.nonzero(in_list & (((gm >> g) & 1) != 0)).squeeze(1)
            if act.numel() == 0:
                continue
            ids = cid[act, None] * CT + g * KG + kk              # (A, KG)
            blk = cols[:N_RAST][:, ids.long()][..., None]     # (15, A, KG, 1)
            pxa = px[act][:, None, :]                         # (A, 1, P)
            pya = py[act][:, None, :]

            def edge_ok(i):
                e = blk[i] * pxa + blk[3 + i] * pya + blk[6 + i]
                return e > blk[9 + i]

            inside = edge_ok(0) & edge_ok(1) & edge_ok(2)
            z = blk[12] * pxa + blk[13] * pya + blk[14]        # (A, KG, P)
            zl_a = zl[act]
            il_a = il[act]
            zlim = zl_a[:, layers - 1, :]
            if zhi is not None:
                zlim = torch.minimum(zlim, zhi[act, 0, :])
            if opaque_cull:
                zlim = torch.minimum(zlim, zop[act])
            zok = inside & (z >= 0.0) & (z <= zlim[:, None, :])
            zm = torch.where(zok, z, inf)
            if opaque_cull:
                tex = cols[TEX_ROW][ids.long()]                 # (A, KG)
                op_row = (tex == torch.floor(tex))[..., None]
                opz = torch.minimum(
                    torch.where(zok & op_row, z, inf).amin(1), zop[act])
                zop[act] = opz
                zm = torch.where(zm <= opz[:, None, :], zm, inf)
            if not bool(torch.isfinite(zm).any()):
                continue
            for _ in range(layers):
                zmin = zm.amin(1)                             # (A, P)
                winner_k = torch.where(
                    (zm == zmin[:, None, :])
                    & torch.isfinite(zmin)[:, None, :],
                    kk[None, :, None], -1).amax(1)
                new_id = torch.where(winner_k >= 0,
                                     cid[act, None] * CT + g * KG + winner_k,
                                     -1)
                prec = (zl_a < zmin[:, None, :]) | (
                    (zl_a == zmin[:, None, :]) & (il_a > new_id[:, None, :]))
                pos = prec.sum(1, keepdim=True)               # (A, 1, P)
                zprev = torch.cat([zl_a[:, :1], zl_a[:, :-1]], 1)
                iprev = torch.cat([il_a[:, :1], il_a[:, :-1]], 1)
                take = li == pos
                shift = li > pos
                zl_a = torch.where(take, zmin[:, None, :],
                                   torch.where(shift, zprev, zl_a))
                il_a = torch.where(take, new_id[:, None, :],
                                   torch.where(shift, iprev, il_a))
                zm = torch.where(kk[None, :, None] == winner_k[:, None, :],
                                 inf, zm)
            zl[act] = zl_a
            il[act] = il_a

    if opaque_cull:
        il = torch.where(zl > zop[:, None, :], -1, il)
    covered = il >= 0
    nc = _n_coef(light)
    coef = cols[N_RAST:N_RAST + nc][:, il.clamp(min=0).long()]
    coef = torch.where(covered, coef, 0.0)             # (nc, tiles, L, P)
    zl = torch.where(covered, zl, 1.0)
    pxl, pyl = px[:, None, :], py[:, None, :]
    if mode == "mtap":
        planes = _mtap_epilogue(coef, pxl, pyl, w_eps, light)
        return zl, il, torch.stack(planes, 2).reshape(
            n_tiles, layers * ATTRS_MTAP, P)
    planes, tapidx = _tap_epilogue(coef, pxl, pyl, w_eps, light)
    tattrs = torch.stack(planes, 2).reshape(n_tiles, layers * ATTRS_TAP, P)
    return zl, il, tattrs, tapidx


def unflatten_tiles(x, height: int, width: int):
    """(n_tiles, 1, P) or (n_tiles, P) tile-major → (height, width)."""
    n_ty = height // TILE_H
    n_tx = width // TILE_W
    return (x.reshape(n_ty, n_tx, TILE_H, TILE_W)
            .permute(0, 2, 1, 3)
            .reshape(height, width))
