"""Device stages of a frame — vertex, setup, binning, raster, shade, pack.

The counterpart of ``mt_renderer_tpu/render/device.py``: the
single-layer frame (``render_frame``), packed or not, and the peeled
(order-independent transparency) frame (``render_frame_peeled``,
``peel_mode`` "split", "ml" or "multipass"), each bilinear tap or, with
``mipmap``, trilinear; lit or unlit; on the binned tile raster
(``backend="pallas"``, the port's default) or on the scan backend
(``backend="scan"``, the reference's default and its independent
oracle: ``setup_stage``, ``raster_stage`` or ``raster_multilayer``,
``shade_src`` with the samplers ``sample_bilinear`` and
``sample_trilinear``, ``blend_over``; plain PyTorch, as the reference's
is plain XLA). The single-layer frame on the binned raster runs:

1. ``vertex_stage`` — bone-palette skinning (a gather and a weighted
   sum) + MVP, written as elementwise fp32 ops;
2. ``setup_packed_cols`` — edge coefficients, top-left/snap bias
   (``REJECT`` for invalid triangles), the z, u/w, v/w and 1/w planes,
   the opacity code in the tex column, C rgba and the mip-0 constants,
   as one column-major ``(33, Tp)`` matrix (``(42, Tp)`` with the
   normal planes when lit, from ``world_normals``), plus 32-triangle
   group bboxes;
3. ``raster.prebin`` — per-tile chunk lists and group masks;
4. ``raster.raster_fwd`` — the K1 kernel with its tap (or, mipmapped,
   mtap) epilogue, the lambert factor folded into C when lit;
5. ``shade_finish_tap_flat`` — the compacted quad-pool gather, bilinear
   filter, color modulate, src-alpha blend and RGBA pack; mipmapped,
   ``shade_mip_tap_flat_channels`` — the compacted trilinear shade with
   an analytic LOD (one 64 B gather per pixel from the tri pool, two
   16 B gathers from the quad pool) — then the blend and pack;
6. ``raster.unflatten_tiles`` + the deferred overflow queue.

The split peel partitions the setup by opacity
(``setup_packed_cols(opacity_split=True)``), rasters the opaque set
through K1 and the translucent set through the multi-layer kernel K2
(``raster.raster_fwd_ml``) behind the opaque z, shades the opaque pass
and composites the translucent layers in front of it
(``composite_peeled_tap_flat``; mipmapped, both kernels run the mtap
epilogue and ``composite_peeled_mip_flat`` shades the layers
trilinearly). The multipass peel bins once and runs K1 once per layer,
each pass excluding depths at or in front of the previous layer +
``PEEL_EPS`` (``raster_fwd(zlow=...)``): the tap epilogue and the dense
tap shade, or mipmapped K1's plain-attributes epilogue and ``shade_fwd``;
the passes blend back to front (``blend_over_planes``).

Pixel rules (coverage at centers with the top-left rule and edge-snap
band folded into a per-edge bias, back-face cull of area2 >= 0, the
``0 <= z`` test, LessEqual depth with later-global-id tie wins) match
``render.cpu_reference`` (this package's copy of the JAX package's NumPy
oracle).

Tensors live on the scene's device; every function takes its device from
its inputs. The host sizing helpers (``auto_maxc``, ``auto_tap_tiles``)
run in NumPy on the host ``DrawBatch`` and never touch the device; the
frame engine's guard counts the same needs on the device instead
(``guard_counts``).

The packed frame is an int32 tensor holding the RGBA8 bits (PyTorch has
few uint32 ops); ``unpack_rgba`` views it as (H, W, 4) uint8 on the
host. ``bilin_swar`` (kernel K4, ``csrc/bilin_swar.cu``) is the integer
SWAR form of the bilinear contraction that
``mt_renderer_tpu_torch.tools.bilin_ab`` prices against the f32 one.
``bc7_trilinear`` (the op ``mtr::bc7_trilinear``, ``csrc/bc7_trilinear.cu``
on CUDA) is a bc7 pool's trilinear sample, its plain twin
``bc7_trilinear_reference``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import logging
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build, native
from ..scene.model import DEBUG_PALETTE, DrawBatch
from ..utils.profiling import count, span
from . import bcn
from . import cpu_reference as cr
from . import raster as rs

logger = logging.getLogger("mt_renderer_tpu_torch.device")

W_EPS = 1e-6
SEG_PX = 2048          # tap-compaction row: one whole flattened tile
TRI_PAD = 384          # triangle-count padding quantum: one raster chunk
DEFAULT_CHUNK = 16     # triangles per scan-backend step
PEEL_EPS = 1e-6        # multipass peel layer separation (NDC depth units)

POOL_MODES = ("quad", "narrow", "auto", "tri", "bc1", "bc7")
# physical row bytes of each stored pool: "tri" and "bc1" pack two 64 B
# logical rows into each 128 B row; a "bc7" row is one 128 B logical row
POOL_ROW_BYTES = {"quad": 16, "narrow": 4, "tri": 128, "bc1": 128,
                  "bc7": 128}


TENSOR_FIELDS = (
    "positions", "uvs", "normals", "joints", "weights",
    "tri_texture", "tri_debug_id", "tri_flat", "tri_material", "mat_color",
    "tri_valid", "tri_parts", "parts_mask", "tex_size",
    "mip_pool", "mip_table", "cols_const", "tri_vis", "aux_pool",
)
STATIC_FIELDS = ("num_joints", "skinned", "num_mips", "pool_mode",
                 "bc7_modes")


@dataclass
class DeviceScene:
    """A DrawBatch uploaded once to device memory. Geometry is
    de-indexed, corner-planar: V = 3*Tp rows, [all corner 0s | all
    corner 1s | all corner 2s]."""

    positions: torch.Tensor     # (3Tp, 3) f32
    uvs: torch.Tensor           # (3Tp, 2) f32
    normals: torch.Tensor       # (3Tp, 3) f32 (zeros when the layout has none)
    joints: torch.Tensor        # (3Tp, W) i32
    weights: torch.Tensor       # (3Tp, W) f32
    tri_texture: torch.Tensor   # (Tp,) i32 texture, -1 = untextured
    tri_debug_id: torch.Tensor  # (Tp,) i32
    tri_flat: torch.Tensor      # (Tp, 4) f32 flat color 0-255; alpha<0 = unused
    tri_material: torch.Tensor  # (Tp,) i32 material slot
    mat_color: torch.Tensor     # (M, 4) f32 per-material RGBA multiplier 0-1
    tri_valid: torch.Tensor     # (Tp,) bool — False for padding
    tri_parts: torch.Tensor     # (Tp,) i32 parts_no per triangle
    parts_mask: torch.Tensor    # (P,) bool per-part visibility
    tex_size: torch.Tensor      # (L, 2) i32 (h, w) per texture
    # all mips; "quad": (R, 16) u8, a texel's 2x2 quad per row;
    # "narrow": (R, 4) u8, one texel per row; "tri": (ceil(R/2), 128)
    # u8, two 64 B logical rows per physical row, each the quad plus the
    # 3x3 level-(m+1) parent block (_build_tri_pool); "bc1": (ceil(B/2),
    # 128) u8, two 64 B logical rows per physical row, one per 4x4 BC1
    # block: its 2x2 block group and a 2x2 level-(m+1) parent block
    # group (_build_bc1_pool); "bc7": (B, 128) u8, one row per 4x4 BC7
    # block: its 2x2 block group (bytes 0-63) and a 2x2 level-(m+1)
    # parent block group (bytes 64-127) (_build_bc7_pool)
    mip_pool: torch.Tensor
    # (L, M, 3) i32 — (offset, h, w) per mip; offsets in texel rows, or
    # in block rows for "bc1" and "bc7"
    mip_table: torch.Tensor
    # per-triangle constants, column-major (10, Tp): [tex, cbase rgba
    # (1 for textured, flat/debug color otherwise), off_hi, off_lo, th,
    # tw, texture fully opaque]
    cols_const: torch.Tensor    # (10, Tp) f32
    tri_vis: torch.Tensor       # (Tp,) bool — tri_valid & parts_mask[tri_parts]
    # the bc7 pool's partition hints (bcn.bc7_block_hints, 8 B a block)
    # in the bc1 pool's geometry, (ceil(B/2), 128) u8, present only when
    # a partitioned mode (0-3, 7) is; otherwise a (1, 128) zero row
    aux_pool: torch.Tensor
    num_joints: int
    skinned: bool
    num_mips: int = 1
    pool_mode: str = "quad"
    # the BC7 modes present in a bc7 pool's blocks: the sampler decodes
    # only these
    bc7_modes: tuple = ()

    @property
    def device(self) -> torch.device:
        return self.positions.device


# ------------------------------------------------------------------ upload


def _mip_downsample(img: np.ndarray) -> np.ndarray:
    """One 2x2 box-filter mip step, (h, w, 4) u8 -> (h/2, w/2, 4) u8."""
    h, w = img.shape[:2]
    h2, w2 = max(h // 2, 1), max(w // 2, 1)
    x = img[: h2 * 2, : w2 * 2].astype(np.uint16)
    if h >= 2 and w >= 2:
        x = (x.reshape(h2, 2, w2, 2, 4).sum((1, 3)) + 2) >> 2
    elif w >= 2:
        x = (x.reshape(h2, w2, 2, 4).sum(2) + 1) >> 1
    elif h >= 2:
        x = (x.reshape(h2, 2, w2, 4).sum(1) + 1) >> 1
    return x.astype(np.uint8)


def mip_chain(img: np.ndarray) -> list:
    """Full mip pyramid of one (h, w, 4) u8 texture down to 1x1."""
    chain, cur = [img], img
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        cur = _mip_downsample(cur)
        chain.append(cur)
    return chain


def quad_rows(img: np.ndarray) -> np.ndarray:
    """(h, w, 4) u8 → (h*w, 16): texel + right/down/down-right
    neighbours (clamp-to-edge baked in), one bilinear tap per row."""
    h, w = img.shape[:2]
    xr = np.minimum(np.arange(w) + 1, w - 1)
    yd = np.minimum(np.arange(h) + 1, h - 1)
    return np.concatenate(
        [img, img[:, xr], img[yd], img[yd][:, xr]], axis=-1
    ).reshape(-1, 16)


_TRI_BUILD_CHUNK = 1 << 23      # logical rows per tri-pool build step


def _tri_chunk_rows(qpool, segs, r0: int, chunk: int):
    """One build step of the 64 B tri pool: rows [r0, r0+chunk) of the
    quad pool (clamped to its last row) gain their 3x3 level-(m+1)
    parent block (bytes 16-51, the RGBA of each parent texel; bytes 52-63
    zero). ``segs`` (S, 6) i32 [off, h, w, poff, ph, pw] sorted by off —
    one row per stored (texture, mip) level; poff = -1 for a texture's
    last real level (the trilinear sampler never reads its parent bytes
    there)."""
    dev = qpool.device
    rows = qpool.shape[0]
    rid = (r0 + torch.arange(chunk, dtype=torch.int32, device=dev)).clamp(
        max=rows - 1)
    seg = torch.searchsorted(segs[:, 0].contiguous(), rid, right=True) - 1
    seg = seg.clamp(0, segs.shape[0] - 1)
    off, h, w, poff, ph, pw = (segs[:, i][seg] for i in range(6))
    local = rid - off
    x = local % w.clamp(min=1)
    y = local // w.clamp(min=1)
    k = (x >> 1) - 1
    j = (y >> 1) - 1
    has_p = poff >= 0
    parts = [qpool[rid.long()]]
    for dy in range(3):
        for dx in range(3):
            px = torch.minimum((k + dx).clamp(min=0), (pw - 1).clamp(min=0))
            py = torch.minimum((j + dy).clamp(min=0), (ph - 1).clamp(min=0))
            pidx = torch.where(has_p, poff + py * pw + px, 0)
            parts.append(torch.where(has_p[:, None],
                                     qpool[pidx.long()][:, :4], 0))
    parts.append(torch.zeros((chunk, 12), dtype=torch.uint8, device=dev))
    return torch.cat(parts, 1)                           # (chunk, 64)


def _bc1_chunk_rows(cpool, segs, r0: int, chunk: int):
    """One build step of the bc1 (or bc7) pool: logical rows [r0,
    r0+chunk) (clamped to the last block) gain their 2x2 child block
    group (the first four blocks: self, right, down, down-right, clamped
    to the level's edge) and their 2x2 level-(m+1) parent block group
    (the last four, anchored at A = (2·bx − 1) >> 2 per axis: the anchor
    whose group holds every parent bilinear footprint of this block, see
    ``_bc1_trilinear_fused``). ``cpool`` (B, k) u8 compact blocks (k = 8
    for BC1, 16 for BC7, 8 for the bc7 pool's hints), so a row is 8k B;
    ``segs`` (S, 6) i32 [off, bh, bw, poff, pbh, pbw] in block units,
    sorted by off; poff = -1 for a texture's last real level (parent
    bytes zero, never read)."""
    dev = cpool.device
    rows = cpool.shape[0]
    rid = (r0 + torch.arange(chunk, dtype=torch.int32, device=dev)).clamp(
        max=rows - 1)
    seg = torch.searchsorted(segs[:, 0].contiguous(), rid, right=True) - 1
    seg = seg.clamp(0, segs.shape[0] - 1)
    off, bh, bw, poff, pbh, pbw = (segs[:, i][seg] for i in range(6))
    local = rid - off
    bx = local % bw.clamp(min=1)
    by = local // bw.clamp(min=1)

    def clip(x, hi):
        return torch.minimum(x.clamp(min=0), (hi - 1).clamp(min=0))

    parts = []
    for dy in (0, 1):
        for dx in (0, 1):
            parts.append(cpool[(off + clip(by + dy, bh) * bw
                                + clip(bx + dx, bw)).long()])
    ax = clip((2 * bx - 1) >> 2, pbw)
    ay = clip((2 * by - 1) >> 2, pbh)
    has_p = poff >= 0
    for dy in (0, 1):
        for dx in (0, 1):
            pidx = torch.where(has_p, poff + clip(ay + dy, pbh) * pbw
                               + clip(ax + dx, pbw), 0)
            parts.append(torch.where(has_p[:, None], cpool[pidx.long()], 0))
    return torch.cat(parts, 1)                           # (chunk, 8k)


def _packed_pool_build(src, segs_h: np.ndarray, rowfn, per_row: int = 2):
    """``src`` (R, k) u8 → (ceil(R/per_row), 128) u8, built on ``src``'s
    device in chunks of logical rows (``rowfn``: ``_tri_chunk_rows`` or
    ``_bc1_chunk_rows``), ``per_row`` of them to a physical row: two 64 B
    rows as the reference packs the tri and bc1 pools (an odd R repeats
    the last logical row), or one 128 B row (bc7). Peak memory is
    ``src``, the output and one chunk's temporaries."""
    rows = src.shape[0]
    if segs_h.size == 0:
        segs_h = np.array([[0, 1, 1, -1, 1, 1]], np.int32)
    segs = torch.as_tensor(np.asarray(segs_h, np.int32), device=src.device)
    n = -(-rows // per_row)
    chunk = min(_TRI_BUILD_CHUNK // per_row, max(1 << 11, n), n)
    out = torch.empty((n, 128), dtype=torch.uint8, device=src.device)
    for start in range(0, n, chunk):
        s = min(start, n - chunk)
        out[s:s + chunk] = rowfn(src, segs, per_row * s,
                                 per_row * chunk).reshape(chunk, 128)
    return out


def _build_tri_pool(qpool, segs_h: np.ndarray):
    """(R, 16) u8 quad pool → (ceil(R/2), 128) u8 tri pool: logical 64 B
    rows (quad + 3x3 parent block). ``_pool_rows`` reads logical row i
    as 64 B row i of the same bytes, so a trilinear tap is one 64 B
    gather."""
    return _packed_pool_build(qpool, segs_h, _tri_chunk_rows)


def _build_bc1_pool(cpool, segs_h: np.ndarray):
    """(B, 8) u8 compact BC1 blocks → (ceil(B/2), 128) u8 bc1 pool:
    logical 64 B rows (child 2x2 block group + parent 2x2 block group),
    packed as the tri pool is. Built on the blocks' device, so the host
    uploads only the compact blocks (0.5 B per source texel)."""
    return _packed_pool_build(cpool, segs_h, _bc1_chunk_rows)


def _build_bc7_pool(cpool, segs_h: np.ndarray):
    """(B, 16) u8 compact BC7 blocks → (B, 128) u8 bc7 pool: each row the
    2x2 child block group and the 2x2 parent block group of one block
    (``_bc1_chunk_rows``' geometry at 16 B a block: eight blocks fill the
    128 B row, one logical row to a physical row). Built on the blocks'
    device, so the host uploads only the compact blocks (1 B per source
    texel)."""
    return _packed_pool_build(cpool, segs_h, _bc1_chunk_rows, per_row=1)


def _bc7_modes_of(byte0: np.ndarray) -> tuple:
    """The BC7 modes present among blocks with first bytes ``byte0``."""
    byte0 = np.asarray(byte0, np.int64)
    return tuple(m for m in range(8)
                 if ((byte0 & ((1 << (m + 1)) - 1)) == (1 << m)).any())


def _bc7_needs_hint(modes) -> bool:
    """Partitioned modes (2 or 3 subsets) read the baked hint pool."""
    return any(m in bcn._PARTITIONED for m in modes)


def _hint_bytes(hints: np.ndarray) -> np.ndarray:
    """(B, 2) u32 ``bcn.bc7_block_hints`` → (B, 8) u8, each word's bytes
    little-endian, packed with shifts and masks (so on any host; the
    reference views the words' memory, which assumes a little-endian
    host)."""
    h = np.asarray(hints, np.uint32)
    return np.stack([(h[:, k // 4] >> np.uint32(8 * (k % 4))) & 0xFF
                     for k in range(8)], 1).astype(np.uint8)


def pool_budget_default(device) -> int | None:
    """The texel-pool byte budget for a pool on ``device``:
    ``MTR_POOL_BUDGET_MB`` when it is set; else 3/4 of the card's total
    memory (``torch.cuda.get_device_properties``) for a CUDA device;
    else None (a CPU upload is unbudgeted)."""
    mb = os.environ.get("MTR_POOL_BUDGET_MB")
    if mb:
        return int(float(mb) * 2**20)
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory * 3 // 4


# bytes the budget charges per logical pool row: the stored pool once.
# The reference charges twice that (device.py:576-581), for the copy XLA
# makes of a gathered-from pool inside its program; torch makes none.
POOL_BUDGET_ROW_BYTES = {"quad": 16, "narrow": 4, "tri": 64, "bc1": 64,
                         "bc7": 128}
# a bc7 pool's hint pool, per block, charged only where it is built (a
# partitioned mode present); the reference charges it always
# (device.py:572-574)
HINT_BUDGET_ROW_BYTES = 64


def _pool_row_count(chains, mode: str) -> int:
    """Logical pool rows of the mip ``chains`` in ``mode``: one per
    texel, or one per 4x4 block for "bc1" and "bc7"."""
    if mode in ("bc1", "bc7"):
        return sum(((img.shape[0] + 3) // 4) * ((img.shape[1] + 3) // 4)
                   for chain in chains for img in chain)
    return sum(img.shape[0] * img.shape[1]
               for chain in chains for img in chain)


def _pool_need(rows: int, mode: str, hint: bool = False) -> int:
    return rows * (POOL_BUDGET_ROW_BYTES[mode]
                   + (HINT_BUDGET_ROW_BYTES if hint else 0))


def _block_dims(img) -> tuple[int, int]:
    return (img.shape[0] + 3) // 4, (img.shape[1] + 3) // 4


def upload(batch: DrawBatch, pool_mode: str = "quad", *, device,
           pool_budget_bytes: int | None = None,
           pool_bias: int | str = 0, mipmap: bool | None = None,
           mip_chains: list | None = None,
           bc1_chains: list | None = None,
           bc7_chains: list | None = None) -> DeviceScene:
    """Pad a host DrawBatch to whole chunks and copy it to ``device``.
    Called once at load time. Every texture's mip chain (2x2 box filter
    down to 1x1) goes into one flat texel pool.

    ``pool_mode``:
    - ``"quad"``: each row holds a texel's 2x2 bilinear footprint (16 B
      per texel; one gather per bilinear tap, two per trilinear tap);
    - ``"narrow"``: bare RGBA rows (4 B per texel); the trilinear shade
      takes four clamped gathers per level; the bilinear tap paths
      refuse it;
    - ``"tri"``: 64 B per texel, the quad plus the 3x3 parent-level
      block every trilinear footprint needs, so a trilinear tap is one
      gather (built on the device from the quad rows); bilinear taps
      read its quad bytes;
    - ``"bc1"``: the textures BC1-encoded at load (``native.encode_bc1``)
      and kept compressed: one 64 B row per 4x4 block holds its 2x2
      block group and its parent level's 2x2 block group (built on the
      device from the compact blocks), so a trilinear tap is one gather
      and eight texel decodes; BC1 is lossy, so it is never chosen
      implicitly; only the mipmapped paths sample it;
    - ``"bc7"``: the textures BC7-encoded at load (mode 6,
      ``bcn.encode_bc7_mode6_numpy``) and kept compressed: one 128 B row
      per 4x4 block holds its 2x2 block group and its parent level's 2x2
      block group (built on the device), so a trilinear tap is one
      gather and eight texel decodes of only the modes present
      (``bc7_modes``); where a partitioned mode (0-3, 7) is present, a
      hint pool (``aux_pool``, 64 B per block) holds each block's
      partition data; like bc1, never chosen implicitly and sampled only
      by the mipmapped paths;
    - ``"auto"``: the first mode that fits the budget: with
      ``mipmap=True`` tri, then quad, then narrow; without, quad, then
      narrow. Each fallback is logged.

    ``pool_budget_bytes`` (default ``pool_budget_default(device)``)
    bounds the pool; a pool over it raises ``MemoryError``, for an
    explicit mode as for "auto". The budget charges the stored pool
    once (``POOL_BUDGET_ROW_BYTES``), where the reference charges it
    twice, and a bc7 pool's hint pool only when it is built, where the
    reference always charges it.

    ``pool_bias``: drop each texture's top ``pool_bias`` mip levels (a
    lossy LOD clamp, never applied implicitly); ``"auto"`` raises it
    only as far as the pool needs to fit the budget, one logged warning
    per step.

    ``mip_chains``: per texture, its mip levels as (h, w, 4) u8 arrays
    (each level half the one before; content is free), in place of the
    box-filter chains. ``bc1_chains`` (``pool_mode="bc1"`` only): per
    texture, its levels as ``(blocks (nb, 8) u8, h, w)``, already
    compressed (``formats.tex.TextureFile.bc1_chain``): the blocks go
    into the pool verbatim, and each level is decoded once on the host
    for the budget, bias and opacity bookkeeping. ``bc7_chains``
    (``pool_mode="bc7"`` only): the same with ``(blocks (nb, 16) u8, h,
    w)`` levels (``formats.tex.TextureFile.bc7_chain``)."""
    if pool_mode not in POOL_MODES:
        raise ValueError(f"unknown pool_mode {pool_mode!r}")
    if bc1_chains is not None and bc7_chains is not None:
        raise ValueError("pass bc1_chains or bc7_chains, not both")
    for name, chains, mode in (("bc1_chains", bc1_chains, "bc1"),
                               ("bc7_chains", bc7_chains, "bc7")):
        if chains is not None and pool_mode != mode:
            raise ValueError(f"{name} requires pool_mode={mode!r}")
        if chains is not None and mip_chains is not None:
            raise ValueError(f"pass mip_chains or {name}, not both")
    if pool_budget_bytes is None:
        pool_budget_bytes = pool_budget_default(device)
    t = len(batch.tris)
    tp = max(TRI_PAD, -(-t // TRI_PAD) * TRI_PAD)
    tris = np.zeros((tp, 3), np.int64)
    tris[:t] = batch.tris
    corner = tris.T.reshape(-1)          # (3Tp,) de-indexing permutation
    tri_tex = np.full(tp, -1, np.int32)
    tri_tex[:t] = batch.tri_texture
    tri_dbg = np.zeros(tp, np.int32)
    tri_dbg[:t] = batch.tri_debug_id
    tri_flat = np.full((tp, 4), -1.0, np.float32)
    if batch.tri_flat is not None:
        tri_flat[:t] = batch.tri_flat
    tri_mat = np.zeros(tp, np.int32)
    tri_mat[:t] = batch.material_ids()
    mat_color = getattr(batch, "mat_color_host", None)
    if mat_color is None:
        mat_color = np.ones((batch.num_materials, 4), np.float32)
    else:
        mat_color = np.asarray(mat_color, np.float32)
    valid = np.zeros(tp, bool)
    valid[:t] = True
    tri_parts = np.zeros(tp, np.int32)
    if batch.tri_parts is not None and len(batch.tri_parts) >= t:
        tri_parts[:t] = batch.tri_parts[:t]
    n_parts = max(8, int(tri_parts.max()) + 1)
    parts_mask = np.ones(n_parts, bool)

    # one flat texel pool for every texture and mip level
    texs = batch.textures or []
    src_texs = texs or [np.zeros((4, 4, 4), np.uint8)]
    if texs:
        sizes = np.array([(x.shape[0], x.shape[1]) for x in texs], np.int32)
    else:
        sizes = np.array([[4, 4]], np.int32)
    raw_chains = None
    bcn_chains = bc1_chains if bc1_chains is not None else bc7_chains
    if bcn_chains is not None:
        # the asset's blocks go into the pool; its levels, decoded once,
        # feed the bookkeeping (budget, bias and opacity read them)
        blk_b, decode = ((8, native.decode_bc1) if bc1_chains is not None
                         else (16, native.decode_bc7))
        raw_chains = [[np.ascontiguousarray(b, np.uint8).reshape(-1, blk_b)
                       for b, _h, _w in chain] for chain in bcn_chains]
        mip_chains = [[decode(np.ascontiguousarray(b, np.uint8).tobytes(),
                              w, h)
                       for b, h, w in chain] for chain in bcn_chains]
    if mip_chains is not None:
        tables = [list(c) for c in mip_chains]
        if len(tables) != len(src_texs):
            raise ValueError(f"{len(tables)} mip chains for "
                             f"{len(src_texs)} textures")
        sizes = np.array([(c[0].shape[0], c[0].shape[1]) for c in tables],
                         np.int32)
    else:
        tables = [mip_chain(img) for img in src_texs]

    def hint_at(bias: int) -> bool:
        """The bc7 pool at ``bias`` holds a partitioned mode: only an
        asset's blocks can (the mode-6 encoder makes none)."""
        if pool_mode != "bc7" or raw_chains is None:
            return False
        return _bc7_needs_hint(_bc7_modes_of(np.concatenate(
            [b[:, 0] for c in raw_chains
             for b in c[min(bias, len(c) - 1):]])))

    # the mode "auto" and pool_bias="auto" size against: the one the
    # caller wants unconstrained (tri for trilinear content, else quad)
    want = pool_mode
    if pool_mode == "auto":
        want = "tri" if mipmap else "quad"
    max_bias = max(len(c) - 1 for c in tables)
    if pool_bias == "auto":
        bias = 0
        while bias < max_bias and pool_budget_bytes is not None:
            chains = [c[min(bias, len(c) - 1):] for c in tables]
            if _pool_need(_pool_row_count(chains, want), want,
                          hint_at(bias)) <= pool_budget_bytes:
                break
            bias += 1
            logger.warning(
                "texel pool: bias -> %d (LOD clamp; dropping each "
                "texture's top mip to fit the %.0f MiB budget)",
                bias, pool_budget_bytes / 2**20)
    else:
        bias = int(pool_bias)
        if bias < 0:
            raise ValueError(f"pool_bias must be >= 0, got {pool_bias}")
    if bias:
        if raw_chains is not None:
            raw_chains = [c[min(bias, len(c) - 1):] for c in raw_chains]
        tables = [c[min(bias, len(c) - 1):] for c in tables]
        sizes = np.array([(c[0].shape[0], c[0].shape[1]) for c in tables],
                         np.int32)
    n_mips = max(len(c) for c in tables)

    total_rows = _pool_row_count(tables, want)
    if pool_mode == "auto":
        candidates = (("tri", "quad", "narrow") if want == "tri"
                      else ("quad", "narrow"))
        pool_mode = candidates[-1]
        for cand in candidates:
            if (pool_budget_bytes is None
                    or _pool_need(total_rows, cand) <= pool_budget_bytes):
                pool_mode = cand
                break
        if pool_mode != want:
            logger.warning(
                "texel pool auto mode: the %s pool (%.0f MiB) exceeds the "
                "%.0f MiB budget — using %s (%.0f MiB; %s)", want,
                _pool_need(total_rows, want) / 2**20,
                pool_budget_bytes / 2**20, pool_mode,
                _pool_need(total_rows, pool_mode) / 2**20,
                "a trilinear tap takes two gathers, not one"
                if want == "tri" and pool_mode == "quad" else
                "a bilinear tap takes four gathers, not one")
    hint = hint_at(0)                    # the chains are biased already
    need = _pool_need(total_rows, pool_mode, hint)
    if pool_budget_bytes is not None and need > pool_budget_bytes:
        bc7_note = (
            f"; the bc7 hint pool's {HINT_BUDGET_ROW_BYTES} B a block is "
            f"charged only when a partitioned mode (0-3, 7) is present "
            f"({'present' if hint else 'absent'} here), where the JAX "
            f"package always charges it" if pool_mode == "bc7" else "")
        raise MemoryError(
            f"texel pool ({pool_mode}) needs {need / 2**20:.0f} MiB > "
            f"budget {pool_budget_bytes / 2**20:.0f} MiB (charged once: "
            f"torch keeps no in-program copy of a gathered-from pool, "
            f"where the JAX package charges twice{bc7_note}) — raise "
            f"MTR_POOL_BUDGET_MB / pool_budget_bytes, pass pool_bias "
            f"(LOD clamp at decode), or split the scene")

    table = np.zeros((len(src_texs), n_mips, 3), np.int32)
    pool_parts = []
    segs = []     # (off, h, w, parent off | -1, ph, pw) per stored level:
    offset = 0    # texel units, or 4x4-block units for "bc1" and "bc7"
    for li, chain in enumerate(tables):
        for mi in range(n_mips):
            if mi >= len(chain):
                table[li, mi] = table[li, len(chain) - 1]
                continue
            img = chain[mi]
            table[li, mi] = (offset, img.shape[0], img.shape[1])
            if pool_mode in ("bc1", "bc7"):
                bh, bw = _block_dims(img)
                if raw_chains is not None:
                    blk = raw_chains[li][mi]
                    if blk.shape[0] != bh * bw:
                        raise ValueError(
                            f"{pool_mode}_chains[{li}][{mi}]: "
                            f"{blk.shape[0]} blocks for a "
                            f"{img.shape[1]}x{img.shape[0]} level "
                            f"({bh * bw} needed)")
                elif pool_mode == "bc7":
                    blk = bcn.encode_bc7_mode6_numpy(img)
                else:
                    blk = native.encode_bc1(img)
                pool_parts.append(blk)
                nxt = (offset + bh * bw, *_block_dims(chain[mi + 1])) \
                    if mi + 1 < len(chain) else (-1, 1, 1)
                segs.append((offset, bh, bw, *nxt))
                offset += bh * bw
                continue
            h, w = img.shape[:2]
            pool_parts.append(img.reshape(-1, 4) if pool_mode == "narrow"
                              else quad_rows(img))
            nxt = (offset + h * w, *chain[mi + 1].shape[:2]) \
                if mi + 1 < len(chain) else (-1, 1, 1)
            segs.append((offset, h, w, *nxt))
            offset += h * w
    mip_pool = np.concatenate(pool_parts)
    src_texels = int(sum(x.shape[0] * x.shape[1] for x in texs))
    pool_bytes = mip_pool.shape[0] * POOL_BUDGET_ROW_BYTES[pool_mode]
    logger.info("texel pool (%s): %d rows, %.2f MiB (%d source texels, "
                "%.2f B/src texel incl. mips)", pool_mode,
                mip_pool.shape[0], pool_bytes / 2**20, src_texels,
                pool_bytes / max(src_texels, 1))
    segs = np.asarray(segs, np.int32)
    aux_pool = np.zeros((1, 128), np.uint8)
    bc7_modes = ()
    if pool_mode == "bc7":
        # only the modes present are decoded at sample time; the hint
        # pool exists only where a partitioned mode does
        bc7_modes = _bc7_modes_of(mip_pool[:, 0])
        if _bc7_needs_hint(bc7_modes):
            aux_pool = _build_bc1_pool(torch.from_numpy(_hint_bytes(
                bcn.bc7_block_hints(mip_pool))).to(device), segs)
    if pool_mode in ("tri", "bc1", "bc7"):
        build = {"tri": _build_tri_pool, "bc1": _build_bc1_pool,
                 "bc7": _build_bc7_pool}[pool_mode]
        mip_pool = build(torch.from_numpy(mip_pool).to(device), segs)

    nj = (len(batch.inverse_bind_mats)
          if batch.inverse_bind_mats is not None else 1)
    if batch.num_vertices == 0:
        corner = np.zeros(3 * tp, np.int64)
        pos_src = np.zeros((1, 3), np.float32)
        uv_src = np.zeros((1, 2), np.float32)
        nrm_src = np.zeros((1, 3), np.float32)
        j_src = np.zeros(
            (1, batch.joints.shape[1] if batch.joints.ndim == 2 else 4),
            np.int32)
        w_src = np.zeros_like(j_src, dtype=np.float32)
    else:
        pos_src = batch.positions.astype(np.float32)
        uv_src = batch.uvs.astype(np.float32)
        nrm_src = batch.normals_or_zero().astype(np.float32)
        j_src = batch.joints.astype(np.int32)
        w_src = batch.weights.astype(np.float32)

    # per-triangle constant columns (see DeviceScene.cols_const)
    lsafe = np.clip(np.maximum(tri_tex, 0), 0, table.shape[0] - 1)
    off0 = table[lsafe, 0, 0].astype(np.int64)
    textured_h = tri_tex >= 0
    use_flat = tri_flat[:, 3] >= 0.0
    pal = np.concatenate(
        [DEBUG_PALETTE.astype(np.float32),
         np.full((20, 1), 255.0, np.float32)], axis=1)
    dbg_rgba = pal[tri_dbg % 20]
    # per-texture full opacity (alpha 255 at every texel of every mip)
    tex_opaque = np.array(
        [all((img[..., 3] == 255).all() for img in chain)
         for chain in tables], bool)
    cols_const = np.empty((10, tp), np.float32)
    cols_const[0] = tri_tex.astype(np.float32)
    for ch in range(4):
        base = np.where(use_flat, tri_flat[:, ch], dbg_rgba[:, ch])
        cols_const[1 + ch] = np.where(textured_h, 1.0, base)
    cols_const[5] = (off0 // 4096).astype(np.float32)
    cols_const[6] = (off0 % 4096).astype(np.float32)
    cols_const[7] = table[lsafe, 0, 1].astype(np.float32)
    cols_const[8] = table[lsafe, 0, 2].astype(np.float32)
    cols_const[9] = np.where(textured_h, tex_opaque[lsafe], True
                             ).astype(np.float32)

    leaves = dict(
        positions=pos_src[corner], uvs=uv_src[corner],
        normals=nrm_src[corner], joints=j_src[corner],
        weights=w_src[corner],
        tri_texture=tri_tex, tri_debug_id=tri_dbg, tri_flat=tri_flat,
        tri_material=tri_mat, mat_color=mat_color,
        tri_valid=valid, tri_parts=tri_parts, parts_mask=parts_mask,
        tex_size=sizes, mip_pool=mip_pool, mip_table=table,
        cols_const=cols_const, tri_vis=valid & parts_mask[tri_parts],
        aux_pool=aux_pool,
    )
    statics = dict(num_joints=nj, skinned=bool(batch.skinned),
                   num_mips=n_mips, pool_mode=pool_mode,
                   bc7_modes=bc7_modes)
    return scene_from_numpy(leaves, statics, device)


def scene_from_numpy(leaves: dict, statics: dict, device) -> DeviceScene:
    """Build a scene from host arrays: ``leaves`` maps every name in
    ``TENSOR_FIELDS`` to a NumPy array (or a tensor), ``statics`` every
    name in ``STATIC_FIELDS`` to its value. The arrays of another
    package's uploaded scene, converted to NumPy, carry its state across,
    any texel pool included (a bc7 scene's hint pool, ``aux_pool``, and
    its ``bc7_modes`` too)."""
    pool_mode = statics["pool_mode"]
    if pool_mode not in POOL_ROW_BYTES:
        raise ValueError(f"unknown pool_mode {pool_mode!r}")
    tensors = {f: (leaves[f].to(device) if isinstance(leaves[f], torch.Tensor)
                   else torch.tensor(np.asarray(leaves[f]), device=device))
               for f in TENSOR_FIELDS}
    for name, row_b in (("mip_pool", POOL_ROW_BYTES[pool_mode]),
                        ("aux_pool", 128)):
        pool = tensors[name]
        if pool.dtype != torch.uint8 or pool.shape[-1] != row_b:
            raise ValueError(f"a {pool_mode} scene's {name} has u8 rows "
                             f"of {row_b} B, got {pool.dtype} "
                             f"{tuple(pool.shape)}")
    statics = dict(statics, bc7_modes=tuple(int(m)
                                            for m in statics["bc7_modes"]))
    return DeviceScene(**tensors, **{k: statics[k] for k in STATIC_FIELDS})


# bytes of host upload per logical pool row: the tri, bc1 and bc7 pools
# are built on the device from the quad rows and the compact blocks
_UPLOAD_ROW_BYTES = {"quad": 16, "narrow": 4, "tri": 16, "bc1": 8, "bc7": 16}


def pool_stats(scene: DeviceScene) -> dict:
    """Texel-pool memory accounting: the pool mode, its logical rows
    (texels, or 4x4 blocks for bc1 and bc7), the bytes it holds on the
    device (a bc7 pool's hint pool included), the bytes its upload sent
    from the host (the hints' 8 B a block included), the source texels
    (mip 0 of every texture) and the bytes per source texel, mips
    included."""
    rows, row_bytes = scene.mip_pool.shape
    if scene.pool_mode in ("tri", "bc1"):   # two 64 B logical rows a row
        rows *= 2
        row_bytes = 64
    src = int(scene.tex_size.cpu().to(torch.int64).prod(1).sum())
    total_b = rows * row_bytes
    upload_b = rows * _UPLOAD_ROW_BYTES[scene.pool_mode]
    if scene.pool_mode == "bc7" and scene.aux_pool.shape[0] > 1:
        upload_b += rows * 8
        total_b += scene.aux_pool.numel()
    return {
        "pool_mode": scene.pool_mode,
        "rows": int(rows),
        "bytes": int(total_b),
        "upload_bytes": int(upload_b),
        "src_texels": src,
        "bytes_per_src_texel": round(total_b / max(src, 1), 2),
    }


def set_parts_mask(scene: DeviceScene, parts_disp) -> DeviceScene:
    """Per-part visibility without a re-upload: a scene sharing every
    buffer of ``scene`` but ``parts_mask`` (parts past ``parts_disp``
    stay visible) and ``tri_vis``, the ``tri_valid & parts_mask[
    tri_parts]`` fold, which runs on the scene's device."""
    p = scene.parts_mask.shape[0]
    mask = np.ones(p, bool)
    pd = np.asarray(parts_disp, bool).reshape(-1)
    mask[: min(p, len(pd))] = pd[:p]
    mask_dev = torch.as_tensor(mask, device=scene.device)
    tri_vis = scene.tri_valid & mask_dev[scene.tri_parts.long()]
    return dataclasses.replace(scene, parts_mask=mask_dev, tri_vis=tri_vis)


# ------------------------------------------------------------------ stages


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _blend_bone_mats(scene: DeviceScene, bone_mats) -> torch.Tensor:
    """(V, 4, 4) per-vertex blended palette matrix: the weighted sum of
    the vertex's bone matrices. Joints outside the palette contribute
    nothing."""
    nj = bone_mats.shape[0]
    j = scene.joints.long()
    wt = torch.where((j >= 0) & (j < nj), scene.weights, 0.0)
    m = bone_mats.reshape(nj, 16)[j.clamp(0, nj - 1)]       # (V, W, 16)
    out = wt[:, 0, None] * m[:, 0]
    for k in range(1, j.shape[1]):
        out = out + wt[:, k, None] * m[:, k]
    return out.reshape(-1, 4, 4)


def vertex_stage(scene: DeviceScene, view_proj, bone_mats) -> torch.Tensor:
    """Skin + transform → (V, 4) clip coords. ``view_proj`` (4, 4) and
    ``bone_mats`` (J, 4, 4) may be NumPy arrays or tensors."""
    dev = scene.device
    pos = scene.positions
    if scene.skinned and bone_mats is not None:
        blended = _blend_bone_mats(scene, _f32(bone_mats, dev))
        skinned = torch.stack(
            [blended[:, i, 0] * pos[:, 0] + blended[:, i, 1] * pos[:, 1]
             + blended[:, i, 2] * pos[:, 2] + blended[:, i, 3]
             for i in range(3)], 1)
        # zero-weight vertices (merged unskinned geometry) pass through
        has_w = scene.weights.sum(1, keepdim=True) > 0
        pos = torch.where(has_w, skinned, pos)
    vp = _f32(view_proj, dev)
    return torch.stack(
        [pos[:, 0] * vp[i, 0] + pos[:, 1] * vp[i, 1] + pos[:, 2] * vp[i, 2]
         + vp[i, 3] for i in range(4)], 1)


def world_normals(scene: DeviceScene, bone_mats) -> torch.Tensor:
    """(V, 3) world-space normals: rotated by the upper 3x3 of the
    vertex's blended bone matrix when skinned (a rigid rotation: no
    inverse transpose, as typical engine skinning does)."""
    nrm = scene.normals
    if scene.skinned and bone_mats is not None:
        rot = _blend_bone_mats(scene, _f32(bone_mats, scene.device))
        rotated = torch.stack(
            [rot[:, i, 0] * nrm[:, 0] + rot[:, i, 1] * nrm[:, 1]
             + rot[:, i, 2] * nrm[:, 2] for i in range(3)], 1)
        has_w = scene.weights.sum(1, keepdim=True) > 0
        nrm = torch.where(has_w, rotated, nrm)
    return nrm


LIGHT_DIR = (0.35, 0.65, 0.67)   # world-space directional light


def _light_unit() -> tuple:
    """LIGHT_DIR normalized in f32, as a tuple of Python floats (the lit
    epilogues' kernel argument)."""
    light = np.asarray(LIGHT_DIR, np.float32)
    light = light / np.linalg.norm(light)
    return tuple(float(c) for c in light)


def _screen(scene: DeviceScene, clip, width: int, height: int):
    """The screen transform of every triangle's corners → (cc (3, Tp, 4)
    corner-planar clip coords, inv_w, sx, sy (three (Tp,) f32 each, one
    per corner), area2 (Tp,), valid (Tp,) bool: visible, in front of the
    eye at every corner, front-facing). ``setup_packed_cols`` and
    ``guard_counts`` both take it, so the guard's boxes are the frame's
    bit for bit."""
    tp = scene.tri_valid.shape[0]
    cc = clip.reshape(3, tp, 4)                           # corner-planar
    w = [cc[i, :, 3] for i in range(3)]
    inv_w = [torch.reciprocal(torch.where(wi.abs() < W_EPS, W_EPS, wi))
             for wi in w]
    sx = [(cc[i, :, 0] * inv_w[i] + 1.0) * (0.5 * width) for i in range(3)]
    sy = [(1.0 - cc[i, :, 1] * inv_w[i]) * (0.5 * height) for i in range(3)]
    area2 = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (
        sx[2] - sx[0])
    valid = (scene.tri_vis & (w[0] > W_EPS) & (w[1] > W_EPS)
             & (w[2] > W_EPS) & (area2 < 0.0))
    return cc, inv_w, sx, sy, area2, valid


_BIG = 1e30               # an empty group's box: never overlaps a tile


def _group_min(vals, v) -> torch.Tensor:
    """(Tp/KG,) least of the three corner values over each KG-triangle
    group's triangles where ``v``."""
    m = torch.minimum(torch.minimum(vals[0], vals[1]), vals[2])
    return torch.where(v, m, _BIG).reshape(-1, rs.KG).amin(1)


def _group_max(vals, v) -> torch.Tensor:
    """(Tp/KG,) greatest of the three corner values, as ``_group_min``."""
    m = torch.maximum(torch.maximum(vals[0], vals[1]), vals[2])
    return torch.where(v, m, -_BIG).reshape(-1, rs.KG).amax(1)


def setup_packed_cols(scene: DeviceScene, clip, width: int, height: int,
                      opacity_split: bool = False, bone_mats=None,
                      lighting: bool = False):
    """Per-triangle setup + forward-attribute planes → (cols (33, Tp)
    f32 column-major in the layout of ``raster``'s module docstring,
    bbox (xmin, xmax, ymin, ymax, zmin) each (Tp/32,) at group
    granularity, over valid triangles only).

    ``lighting`` appends the nx/w, ny/w and nz/w planes of the world
    normals (``world_normals`` under ``bone_mats``): the (42, Tp) lit
    matrix that K1's lit epilogues read.

    ``opacity_split=True`` partitions the triangles by opacity (the
    predicate K2's opaque cull reads from the tex column) and returns
    ((cols_opaque, bbox_opaque), (cols_translucent, bbox_translucent)):
    the same columns, except that each set's complement has its first
    edge bias set to ``REJECT`` (never inside) and is left out of the
    set's group bboxes (never binned). The split peel rasters the
    opaque set single-layer and only the translucent set multi-layer."""
    tp = scene.tri_valid.shape[0]
    cc, inv_w, sx, sy, area2, valid = _screen(scene, clip, width, height)
    sz = [cc[i, :, 2] * inv_w[i] for i in range(3)]
    area = -area2
    inv_area = torch.where(
        area != 0.0,
        torch.reciprocal(torch.where(area == 0.0, 1.0, area)), 0.0)

    ea, eb, ec, bias = [], [], [], []
    for i in range(3):
        ax, ay = sx[(i + 1) % 3], sy[(i + 1) % 3]
        bx, by = sx[(i + 2) % 3], sy[(i + 2) % 3]
        a = by - ay
        b = -(bx - ax)
        c = ay * (bx - ax) - ax * (by - ay)
        topleft = ((ay == by) & (bx < ax)) | (by > ay)
        snap = 1e-6 * (a.abs() * width + b.abs() * height + c.abs())
        bi = torch.where(topleft, -snap * 1.000001, snap)
        bias.append(torch.where(valid, bi, rs.REJECT))
        ea.append(a)
        eb.append(b)
        ec.append(c)

    def plane3(f0, f1, f2):
        """(a, b, c) of the screen plane of sum_i f_i * bary_i."""
        return [
            (f0 * ea[0] + f1 * ea[1] + f2 * ea[2]) * inv_area,
            (f0 * eb[0] + f1 * eb[1] + f2 * eb[2]) * inv_area,
            (f0 * ec[0] + f1 * ec[1] + f2 * ec[2]) * inv_area,
        ]

    zp = plane3(sz[0], sz[1], sz[2])
    uv = scene.uvs.reshape(3, tp, 2)
    up = plane3(*[uv[i, :, 0] * inv_w[i] for i in range(3)])
    vp_ = plane3(*[uv[i, :, 1] * inv_w[i] for i in range(3)])
    wp = plane3(*inv_w)

    # C = material color x cbase (cbase is 1 for textured triangles)
    cst = scene.cols_const
    mat = _mat_select(scene.mat_color, scene.tri_material)   # (4, Tp)
    c_cols = [mat[ch] * cst[1 + ch] for ch in range(4)]

    # per-triangle opacity in the tex column's fraction (integer =
    # opaque): consumers read tex only as >= 0 or by truncation, both
    # of which the half offset preserves (3.5 -> 3, -1.5 -> -1)
    textured = cst[0] >= 0.0
    opq = (c_cols[3] >= torch.where(textured, 1.0, 255.0)) & (cst[9] > 0.0)
    tex_enc = cst[0] + torch.where(textured, 0.5, -0.5) * (
        1.0 - opq.to(torch.float32))

    tail = (zp + up + vp_ + wp
            + [tex_enc] + c_cols + [cst[5], cst[6], cst[7], cst[8]])
    if lighting:
        nc = world_normals(scene, bone_mats).reshape(3, tp, 3)
        for ch in range(3):
            tail += plane3(*[nc[i, :, ch] * inv_w[i] for i in range(3)])

    def finish(bias0, v):
        cols = torch.stack(ea + eb + ec + [bias0] + bias[1:] + tail, 0)
        return cols, (_group_min(sx, v), _group_max(sx, v),
                      _group_min(sy, v), _group_max(sy, v),
                      _group_min(sz, v))          # (33 or 42, Tp), bbox

    if opacity_split:
        return (finish(torch.where(opq, bias[0], rs.REJECT), valid & opq),
                finish(torch.where(opq, rs.REJECT, bias[0]), valid & ~opq))
    return finish(bias[0], valid)


def _mat_select(mat_color, tri_material) -> torch.Tensor:
    """Per-triangle material color → (4, Tp) f32."""
    return mat_color[tri_material.long()].T


# ------------------------------------------------------------ tap shade


def _pool_rows(pool, idx, nbytes: int):
    """The first ``nbytes`` (16: the quad; 64: quad + parent block, or a
    bc1 or hint row; 128: a bc7 row) of logical pool rows ``idx``
    (clamped below at 0), one gather. A tri pool's physical 128 B row i
    holds logical rows 2i and 2i+1, so its logical row i is 64 B row i
    of the same bytes and its quad is 16 B row 4i."""
    idx = idx.clamp(min=0).long()
    if pool.shape[-1] == nbytes and nbytes in (16, 128):
        return pool[idx]
    if pool.shape[-1] != 128:
        raise ValueError(f"a {nbytes} B pool read needs the "
                         f"{'quad or ' if nbytes == 16 else ''}tri pool, got "
                         f"rows of {pool.shape[-1]} B")
    if nbytes == 16:
        return pool.reshape(-1, 16)[4 * idx]
    return pool.reshape(-1, 64)[idx]


def _contract_quad(quad, fx, fy) -> list:
    """The 2x2 bilinear contraction of quad rows (..., 16) u8 (corner-
    major RGBA: texel, right, down, down-right) → 4 channel tensors: one
    expression for every sampler."""
    quad = quad.reshape(quad.shape[:-1] + (4, 4)).to(torch.float32)
    wq = [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy]
    return [wq[0] * quad[..., 0, c] + wq[1] * quad[..., 1, c]
            + wq[2] * quad[..., 2, c] + wq[3] * quad[..., 3, c]
            for c in range(4)]


def _tap_albedo_channels(pool, idx, fx, fy) -> list:
    """One pool gather + the 2x2 bilinear contraction → 4 albedo
    channel tensors shaped like ``idx`` (quad pool, or the quad bytes of
    a tri pool; ``_pool_rows`` refuses a narrow pool's 4 B rows)."""
    return _contract_quad(_pool_rows(pool, idx, 16), fx, fy)


def _check_pool_path(scene: DeviceScene, mipmap: bool) -> None:
    """The binned raster's bilinear tap paths address texel rows of a
    quad or tri pool: a bc1 or bc7 pool (4x4 blocks) renders there only
    through the mipmap path (the scan backend samples its blocks without
    mipmap too), and a narrow pool too (its tap would need four
    gathers)."""
    if mipmap:
        return
    if scene.pool_mode == "narrow":
        raise ValueError(
            "the bilinear tap paths need the quad (16 B/texel) or tri "
            "(64 B) pool: a narrow pool renders through the mipmap path "
            "(upload(..., pool_mode='quad') for this one)")
    if scene.pool_mode in ("bc1", "bc7"):
        raise ValueError(
            f"{scene.pool_mode} pools render via the mipmap path "
            f"(mipmap=True) or the scan backend: the non-mip tap kernel "
            f"addresses texel rows, not 4x4 blocks")


def _blend_channels(src_channels, covered, clear_color) -> list:
    """Src-alpha blend over the clear color → float channel list."""
    clear = [float(c) for c in np.asarray(clear_color, np.float32)]
    a = src_channels[3] / 255.0
    out = [torch.where(covered, src_channels[c] * a + clear[c] * (1.0 - a),
                       clear[c]) for c in range(3)]
    out.append(torch.where(covered, src_channels[3], clear[3]))
    return out


def pack_u32_channels(channels) -> torch.Tensor:
    """Quantize float 0-255 channels → RGBA8 packed into the bits of an
    int32 tensor (view it as uint32 on the host). Packs in int64 and
    keeps the low 32 bits."""
    q = [(o + 0.5).clamp(0.0, 255.0).to(torch.int64) for o in channels]
    p = q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24)
    return torch.where(p >= 2**31, p - 2**32, p).to(torch.int32)


def _blend_pack_u32(src_channels, covered, clear_color) -> torch.Tensor:
    """Blend + RGBA pack (see _blend_channels)."""
    return pack_u32_channels(
        _blend_channels(src_channels, covered, clear_color))


def unpack_rgba(packed) -> np.ndarray:
    """Host view of a packed frame (tensor or array, (H, W) 32-bit) as
    (H, W, 4) uint8 RGBA (little-endian host)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    a = np.ascontiguousarray(packed)
    return a.view(np.uint8).reshape(a.shape[0], a.shape[1], 4)


def _compact_live_rows(live_flat, cap: int):
    """Static-cap compaction bookkeeping: (N,) bool liveness → (src
    (cap,) i32 source row per compact slot, slot (N,) i32 compact slot
    per row — ``cap`` = dead/overflowed, n_over i32 scalar)."""
    n = live_flat.shape[0]
    rank = torch.cumsum(live_flat.to(torch.int32), 0, dtype=torch.int32) - 1
    n_live = rank[n - 1] + 1
    slot = torch.where(live_flat & (rank < cap), rank, cap)
    # every dead row writes slot ``cap``, which is sliced off
    src = torch.zeros(cap + 1, dtype=torch.int32, device=live_flat.device)
    src[slot.long()] = torch.arange(n, dtype=torch.int32,
                                    device=live_flat.device)
    return src[:cap], slot, (n_live - cap).clamp(min=0)


def _expand_rows(albc, slot, n: int) -> list:
    """Scatter compacted per-row channels (4 x (cap, SEG_PX)) back to
    dense rows (4 x (n, SEG_PX)); dead rows read zeros."""
    allc = torch.cat(albc, 1)                             # (cap, 4*SEG)
    allc = torch.cat([allc, allc.new_zeros((1, 4 * SEG_PX))])[slot.long()]
    return [allc[:, c * SEG_PX:(c + 1) * SEG_PX] for c in range(4)]


def shade_tap_flat_channels(scene: DeviceScene, tattrs, tapidx, ib,
                            tap_tiles: int | None = None):
    """Tile-major tap shade → (src channels [r, g, b, a] each
    (n_tiles, P) f32 0-255, covered (n_tiles, P) bool, n_over_tap).

    ``tap_tiles`` compacts the pool gather + contraction to that many
    live (textured and covered) SEG_PX-px rows; None/0 = dense. Size it
    on the host with ``auto_tap_tiles``; overflow is reported through
    the deferred queue."""
    ti = tapidx[:, 0, :]
    covered = ib[:, 0, :] >= 0
    textured = ti >= 0
    nt, p = ti.shape
    n = nt * (p // SEG_PX)
    cap = 0 if tap_tiles is None else min(tap_tiles, n)
    if cap and cap < n:
        live = (covered & textured).reshape(n, SEG_PX).any(1)
        src_rows, slot, n_over_tap = _compact_live_rows(live, cap)
        rows = src_rows.long()
        tic = ti.reshape(n, SEG_PX)[rows]
        fxc = tattrs[:, 0, :].reshape(n, SEG_PX)[rows]
        fyc = tattrs[:, 1, :].reshape(n, SEG_PX)[rows]
        albc = _tap_albedo_channels(scene.mip_pool, tic, fxc, fyc)
        alb = [a.reshape(nt, p) for a in _expand_rows(albc, slot, n)]
    else:
        alb = _tap_albedo_channels(scene.mip_pool, ti, tattrs[:, 0, :],
                                   tattrs[:, 1, :])
        n_over_tap = torch.zeros((), dtype=torch.int32, device=ti.device)
    src = [torch.where(textured, alb[c] * tattrs[:, 2 + c, :],
                       tattrs[:, 2 + c, :]) for c in range(4)]
    return src, covered, n_over_tap


def shade_finish_tap_flat(scene: DeviceScene, tattrs, tapidx, ib,
                          clear_color, tap_tiles: int | None = None):
    """Tile-major shade + blend + pack of ``raster_fwd``'s outputs →
    (packed (n_tiles, P) i32, covered (n_tiles, P) bool, n_over_tap)."""
    src, covered, n_over_tap = shade_tap_flat_channels(
        scene, tattrs, tapidx, ib, tap_tiles=tap_tiles)
    return _blend_pack_u32(src, covered, clear_color), covered, n_over_tap


def composite_peeled_tap_flat(scene: DeviceScene, tattrs, tapidx, il,
                              layers: int, clear_color,
                              tap_tiles: int | None = None,
                              covered=None, dst0=None):
    """Tile-major multi-layer composite over ``raster_fwd_ml``'s tap
    outputs (tattrs (n_tiles, 6L, P), tapidx and il (n_tiles, L, P),
    nearest layer first): one quad-pool gather for every layer's
    bilinear tap, then the layers blend back to front with src-alpha.

    ``tap_tiles`` compacts the gather + contraction to that many live
    (textured and covered) SEG_PX-px rows, i.e. (tile, layer) pairs;
    None/0 = dense. Size it with ``measure_live_tap_tiles``: live rows
    beyond the cap lose their texture and are counted in n_over_tap.
    ``covered`` overrides the per-(tile, layer, pixel) liveness (default
    ``il >= 0``): the split peel culls there the translucent fragments
    behind the opaque winner. ``dst0`` overrides the blend destination
    (a channel list; default the clear color): the split peel starts
    from the shaded opaque frame.

    Returns (channels [r, g, b, a] each (n_tiles, P) f32 0-255, still
    tile-major, n_over_tap)."""
    nt, _, p = tapidx.shape
    a4 = tattrs.reshape(nt, layers, rs.ATTRS_TAP, p)
    textured = tapidx >= 0
    if covered is None:
        covered = il >= 0
    n = nt * layers * (p // SEG_PX)
    cap = 0 if tap_tiles is None else min(tap_tiles, n)
    if cap and cap < n:
        # untextured fragments never read their albedo
        live = (covered & textured).reshape(n, SEG_PX).any(1)
        src_rows, slot, n_over_tap = _compact_live_rows(live, cap)
        rows = src_rows.long()
        tic = tapidx.reshape(n, SEG_PX)[rows]
        fxc = a4[:, :, 0].reshape(n, SEG_PX)[rows]
        fyc = a4[:, :, 1].reshape(n, SEG_PX)[rows]
        albc = _tap_albedo_channels(scene.mip_pool, tic, fxc, fyc)
        alb = [a.reshape(nt, layers, p) for a in _expand_rows(albc, slot, n)]
    else:
        alb = _tap_albedo_channels(scene.mip_pool, tapidx, a4[:, :, 0],
                                   a4[:, :, 1])
        n_over_tap = torch.zeros((), dtype=torch.int32, device=il.device)
    if dst0 is None:
        clear = np.asarray(clear_color, np.float32)
        dst = [torch.full((nt, p), float(clear[c]), device=il.device)
               for c in range(4)]
    else:
        dst = list(dst0)
    for layer in reversed(range(layers)):
        src = [torch.where(textured[:, layer],
                           alb[c][:, layer] * a4[:, layer, 2 + c],
                           a4[:, layer, 2 + c]) for c in range(4)]
        dst = blend_over_planes(src, covered[:, layer], dst)
    return dst, n_over_tap


# ------------------------------------------------------- trilinear shade


def _seg_rows(m):
    """(N, planes, P) → (N*P/SEG_PX, planes, SEG_PX): each plane row cut
    into SEG_PX-px segments, segment-major within a row (the identity at
    SEG_PX = P, the production unit)."""
    n, npl, p = m.shape
    sg = p // SEG_PX
    return m.reshape(n, npl, sg, SEG_PX).transpose(1, 2).reshape(
        n * sg, npl, SEG_PX)


def _analytic_lod(u, v, gux, guy, gvx, gvy, gqx, gqy, th, tw):
    """Per-pixel texture LOD from the winner's own screen planes: u =
    U/Q with U, Q affine, so du/dx = (U_x - u * Q_x) / Q exactly; the g*
    arguments are the gradients already divided by Q (the mtap planes),
    th/tw the texture extents (f32).

    log2 runs in f64 and rounds once to f32: PyTorch's CPU kernels take
    a vectorised or a scalar log2 for an element depending on where the
    tensor's per-thread chunks end, and the two differ by an ulp on some
    inputs, which would let the dense and the compacted shade (the same
    pixels at other offsets) disagree. Both f64 log2s round to the same
    f32 but in cases of measure zero."""
    dudx = gux - u * gqx
    dudy = guy - u * gqy
    dvdx = gvx - v * gqx
    dvdy = gvy - v * gqy
    rho = torch.maximum(
        torch.maximum(dudx.abs(), dudy.abs()) * tw,
        torch.maximum(dvdx.abs(), dvdy.abs()) * th)
    return torch.log2(rho.clamp(min=1e-6).to(torch.float64)).to(
        torch.float32)


def _mip_arith(off0, th, tw, m, num_mips: int):
    """Level-m pool offset and extents from the mip-0 constants: upload
    stores each texture's chain contiguously, level i spanning
    max(th >> i, 1) * max(tw >> i, 1) rows, so this equals the mip table
    with no gather. All arguments i32; m at most the texture's last real
    level."""
    hm = (th >> m).clamp(min=1)
    wm = (tw >> m).clamp(min=1)
    off = off0
    for i in range(num_mips - 1):
        sz = (th >> i).clamp(min=1) * (tw >> i).clamp(min=1)
        off = off + torch.where(m > i, sz, 0)
    return off, hm, wm


def _tap_address(u, v, hm, wm):
    """Bilinear tap of a (hm, wm) level at (u, v) → (x0c, y0c, fx, fy):
    the clamped top-left texel and the fractions (0 where the footprint
    starts left of or above the texture: clamp to edge)."""
    x = u * wm.to(torch.float32) - 0.5
    y = v * hm.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = torch.where(x0 < 0, 0.0, x - x0)
    fy = torch.where(y0 < 0, 0.0, y - y0)
    x0c = torch.minimum(rs._trunc_i32(x0).clamp(min=0), (wm - 1).clamp(min=0))
    y0c = torch.minimum(rs._trunc_i32(y0).clamp(min=0), (hm - 1).clamp(min=0))
    return x0c, y0c, fx, fy


def _quad_bilinear(pool, off, hm, wm, u, v) -> list:
    """Bilinear tap of the level at pool offset ``off`` with extents
    (hm, wm): one 16 B gather + the contraction, or from a narrow (R, 4)
    pool four gathers of the clamped neighbours assembled into the same
    quad (the same contraction, so the same bits)."""
    if pool.shape[-1] == 4:
        x0c, y0c, x1c, y1c, fx, fy = _footprint(wm, hm, u, v)
        quad = torch.cat([pool[(off + yy * wm + xx).long()]
                          for yy, xx in ((y0c, x0c), (y0c, x1c), (y1c, x0c),
                                         (y1c, x1c))], -1)
        return _contract_quad(quad, fx, fy)
    x0c, y0c, fx, fy = _tap_address(u, v, hm, wm)
    return _contract_quad(_pool_rows(pool, off + y0c * wm + x0c, 16), fx, fy)


def _footprint(wm, hm, u, v):
    """A bilinear tap's four clamped texels at one level, the
    expressions of ``_tap_address`` → (x0c, y0c, x1c, y1c, fx, fy)."""
    x0c, y0c, fx, fy = _tap_address(u, v, hm, wm)
    x1c = torch.minimum(x0c + 1, (wm - 1).clamp(min=0))
    y1c = torch.minimum(y0c + 1, (hm - 1).clamp(min=0))
    return x0c, y0c, x1c, y1c, fx, fy


_PARENT_TAPS = (0, 1, 3, 4)      # a 2x2 footprint's starts in a 3x3 block


def _trilinear_fused(pool, off0, hm0, wm0, hm1, wm1, m0, m1, u, v):
    """Both levels of a trilinear tap from one 64 B tri-pool row → (s0,
    s1) channel lists. Bytes 0-15 are the level-m0 quad; bytes 16-51 the
    3x3 level-m1 block anchored at ((x0c >> 1) - 1, (y0c >> 1) - 1), which
    holds the level-m1 footprint (its start (rx, ry) in {0, 1}^2). Where
    m1 == m0 (the texture's last level) s1 is s0, as two gathers of the
    same row would give."""
    x0c, y0c, fx, fy = _tap_address(u, v, hm0, wm0)
    row = _pool_rows(pool, off0 + y0c * wm0 + x0c, 64)
    s0 = _contract_quad(row[..., :16], fx, fy)
    x1c, y1c, fx1, fy1 = _tap_address(u, v, hm1, wm1)
    lin = 3 * (y1c - ((y0c >> 1) - 1)) + (x1c - ((x0c >> 1) - 1))
    lin = torch.where((lin == 0) | (lin == 1) | (lin == 3), lin, 4)
    taps = torch.tensor(_PARENT_TAPS, device=lin.device)
    byte = (16 + 4 * (lin[..., None] + taps))[..., None] + torch.arange(
        4, device=lin.device)
    quad1 = torch.gather(row, -1, byte.reshape(lin.shape + (16,)))
    s1 = _contract_quad(quad1, fx1, fy1)
    deep = m1 > m0
    return s0, [torch.where(deep, a, b) for a, b in zip(s1, s0)]


def _levels(th, tw, lod, num_mips: int):
    """A trilinear tap's two levels from the mip-0 extents: lod clipped
    to [0, num_mips - 1], both levels clamped to the texture's last real
    level → (fm, m0, m1, hm1, wm1)."""
    big = torch.maximum(th, tw)
    mmax = torch.zeros_like(th)
    for m in range(1, num_mips):
        mmax = torch.where((big >> m) > 0, m, mmax)
    lod = lod.clamp(0.0, float(num_mips - 1))
    m0f = torch.floor(lod)
    fm = lod - m0f
    m0 = torch.minimum(rs._trunc_i32(m0f), mmax)
    m1 = torch.minimum(m0 + 1, mmax)
    return fm, m0, m1, (th >> m1).clamp(min=1), (tw >> m1).clamp(min=1)


def _trilinear_arith(pool, off0, th, tw, lod, u, v, num_mips: int,
                     mode: str = "quad", aux=None,
                     bc7_modes: tuple = ()) -> list:
    """Trilinear sample with arithmetic mip addressing (``_mip_arith``)
    → 4 channel tensors: lod clipped to [0, num_mips - 1], both levels
    clamped to the texture's last real level (``_levels``). ``mode`` is
    the scene's pool mode: a tri pool takes both levels from one gather
    (``_trilinear_fused``), a bc1 pool from one gather and eight texel
    decodes (``_bc1_trilinear_fused``; ``off0`` and the offset walk are
    then in block rows), a bc7 pool likewise through the op
    ``mtr::bc7_trilinear`` (``bc7_trilinear``: one 128 B row, the hint
    pool ``aux`` where ``bc7_modes`` holds a partitioned mode, eight
    decodes of the modes ``bc7_modes``), a quad or narrow pool from two
    ``_quad_bilinear`` taps."""
    if mode == "bc7":
        return bc7_trilinear(pool, aux, off0, th, tw, lod, u, v, num_mips,
                             bc7_modes)
    fm, m0, m1, hm1, wm1 = _levels(th, tw, lod, num_mips)
    if mode == "bc1":
        off_a, hm0, wm0 = _mip_arith_bc1(off0, th, tw, m0, num_mips)
        s0, s1 = _bc1_trilinear_fused(pool, off_a, hm0, wm0, hm1, wm1,
                                      m0, m1, u, v)
        return [a * (1 - fm) + b * fm for a, b in zip(s0, s1)]
    off_a, hm0, wm0 = _mip_arith(off0, th, tw, m0, num_mips)
    if mode == "tri":
        s0, s1 = _trilinear_fused(pool, off_a, hm0, wm0, hm1, wm1, m0, m1,
                                  u, v)
    else:
        off_b = off_a + torch.where(m1 > m0, hm0 * wm0, 0)
        s0 = _quad_bilinear(pool, off_a, hm0, wm0, u, v)
        s1 = _quad_bilinear(pool, off_b, hm1, wm1, u, v)
    return [a * (1 - fm) + b * fm for a, b in zip(s0, s1)]


# texels a trilinear tap decodes from a bc7 pool: the 2x2 footprint at
# each of its two levels
TRILINEAR_TEXELS = 8


def _mip_albedo_channels(scene: DeviceScene, m) -> list:
    """Trilinear albedo from mtap planes ``m`` (..., 17, X) → 4 channel
    tensors (..., X): analytic LOD, arithmetic mip addressing; elementwise
    per pixel, so it runs on compacted rows as on dense ones. A bc7
    pool's sampling opens the span ``shade.bc7`` and counts the texels it
    decodes, from the shapes, in ``bc7.texels``."""
    u = m[..., 0, :]
    v = m[..., 1, :]
    off0 = rs._trunc_i32(m[..., 3, :]) * 4096 + rs._trunc_i32(m[..., 4, :])
    th = rs._trunc_i32(m[..., 5, :])
    tw = rs._trunc_i32(m[..., 6, :])
    lod = _analytic_lod(u, v, *[m[..., 11 + i, :] for i in range(6)],
                        m[..., 5, :], m[..., 6, :])

    def sample():
        return _trilinear_arith(scene.mip_pool, off0, th, tw, lod, u, v,
                                scene.num_mips, mode=scene.pool_mode,
                                aux=scene.aux_pool,
                                bc7_modes=scene.bc7_modes)

    if scene.pool_mode != "bc7":
        return sample()
    with span("shade.bc7"):
        count("bc7.texels", u.numel() * TRILINEAR_TEXELS)
        return sample()


# ------------------------------------------------- bc1-resident sampling


def _bc1_words(row, n: int = 8):
    """(..., 64) u8 bc1 rows → per-block endpoint words (c0, c1) i32 and
    index words, for the first ``n`` of the 8 baked blocks (0-3 the child
    group, 4-7 the parent group). Each 32-bit index word is held in int64
    (torch has no uint32 arithmetic on every device), so it stays
    non-negative with bit 31 set and its right shifts are logical."""
    u = row.to(torch.int32)
    u64 = row.to(torch.int64)
    c0s, c1s, bits = [], [], []
    for s in range(n):
        o = 8 * s
        c0s.append(u[..., o] | (u[..., o + 1] << 8))
        c1s.append(u[..., o + 2] | (u[..., o + 3] << 8))
        bits.append(u64[..., o + 4] | (u64[..., o + 5] << 8)
                    | (u64[..., o + 6] << 16) | (u64[..., o + 7] << 24))
    return c0s, c1s, bits


def _bc1_texel(c0, c1, bits, xt, yt) -> list:
    """Decode one BC1 texel at texel coordinates (xt, yt) from its
    block's words: the integer arithmetic of ``bcn.decode_bc1_numpy``
    (565 expand, (2a + b + 1) // 3 interpolants, three-color
    punch-through). Returns [r, g, b, a] i32."""
    code = ((bits >> (2 * ((yt & 3) * 4 + (xt & 3)))) & 3).to(torch.int32)
    four = c0 > c1
    out = []
    for a, b in zip(bcn._rgb565_to_rgb888(c0), bcn._rgb565_to_rgb888(c1)):
        p2 = torch.where(four, bcn._div3(2 * a + b + 1), (a + b) >> 1)
        p3 = torch.where(four, bcn._div3(a + 2 * b + 1), 0)
        out.append(torch.where(code == 0, a, torch.where(
            code == 1, b, torch.where(code == 2, p2, p3))))
    out.append(torch.where((code == 3) & ~four, 0, 255).to(torch.int32))
    return out


def _bc1_quad(c0s, c1s, bits, base: int, taps):
    """The 2x2 bilinear footprint decoded from a baked 2x2 block group
    (blocks base..base+3): ``taps`` are 4 tuples (xt, yt, sx, sy) in
    ``_contract_quad``'s corner order, sx/sy the tap's block within the
    group ({0, 1} tensors, or None where it is the group's first).
    Returns (..., 16) i32 texels, corner-major RGBA like a quad row."""
    def pick(vals, sx, sy):
        if sx is None and sy is None:
            return vals[base]
        if sy is None:
            return torch.where(sx == 1, vals[base + 1], vals[base])
        if sx is None:
            return torch.where(sy == 1, vals[base + 2], vals[base])
        lo = torch.where(sx == 1, vals[base + 1], vals[base])
        hi = torch.where(sx == 1, vals[base + 3], vals[base + 2])
        return torch.where(sy == 1, hi, lo)

    return torch.stack(
        [ch for xt, yt, sx, sy in taps
         for ch in _bc1_texel(pick(c0s, sx, sy), pick(c1s, sx, sy),
                              pick(bits, sx, sy), xt, yt)], -1)


def _mip_arith_bc1(off0, th, tw, m, num_mips: int):
    """Level-m block-row offset and texel extents from the mip-0
    constants: the bc1 twin of ``_mip_arith`` (level i spans
    ceil(h_i / 4) · ceil(w_i / 4) block rows, as upload lays it out)."""
    hm = (th >> m).clamp(min=1)
    wm = (tw >> m).clamp(min=1)
    off = off0
    for i in range(num_mips - 1):
        bh = ((th >> i).clamp(min=1) + 3) >> 2
        bw = ((tw >> i).clamp(min=1) + 3) >> 2
        off = off + torch.where(m > i, bh * bw, 0)
    return off, hm, wm


def _bc1_trilinear_fused(pool, off0, hm0, wm0, hm1, wm1, m0, m1, u, v):
    """Both levels of a trilinear tap from one 64 B bc1 row and eight
    BC1 texel decodes → (s0, s1) channel lists. The row holds the child
    2x2 block group at (x0c >> 2, y0c >> 2), which contains any level-m0
    footprint that starts in its first block, and the parent 2x2 block
    group anchored at A = (2·bx − 1) >> 2 per axis: the level-m1
    footprint spans texels [2·bx − 1, 2·bx + 2] (the tri pool's law), at
    most two consecutive parent blocks {A, A + 1}. The decoded integers
    equal a quad pool's of the decoded chains, and the same
    ``_contract_quad`` runs, so the result equals that pool's bit for
    bit; where m1 == m0 (the texture's last level) s1 is s0."""
    x0c, y0c, x1c, y1c, fx, fy = _footprint(wm0, hm0, u, v)
    bx = x0c >> 2
    by = y0c >> 2
    row = _pool_rows(pool, off0 + by * ((wm0 + 3) >> 2) + bx, 64)
    c0s, c1s, bits = _bc1_words(row)
    rx = ((x1c >> 2) - bx).clamp(0, 1)
    ry = ((y1c >> 2) - by).clamp(0, 1)
    s0 = _contract_quad(_bc1_quad(
        c0s, c1s, bits, 0, [(x0c, y0c, None, None), (x1c, y0c, rx, None),
                            (x0c, y1c, None, ry), (x1c, y1c, rx, ry)]),
        fx, fy)
    xp0, yp0, xp1, yp1, fx1, fy1 = _footprint(wm1, hm1, u, v)
    ax = torch.minimum(((2 * bx - 1) >> 2).clamp(min=0),
                       (((wm1 + 3) >> 2) - 1).clamp(min=0))
    ay = torch.minimum(((2 * by - 1) >> 2).clamp(min=0),
                       (((hm1 + 3) >> 2) - 1).clamp(min=0))
    # every parent tap may land in either column or row of the group
    sx0 = ((xp0 >> 2) - ax).clamp(0, 1)
    sx1 = ((xp1 >> 2) - ax).clamp(0, 1)
    sy0 = ((yp0 >> 2) - ay).clamp(0, 1)
    sy1 = ((yp1 >> 2) - ay).clamp(0, 1)
    s1 = _contract_quad(_bc1_quad(
        c0s, c1s, bits, 4, [(xp0, yp0, sx0, sy0), (xp1, yp0, sx1, sy0),
                            (xp0, yp1, sx0, sy1), (xp1, yp1, sx1, sy1)]),
        fx1, fy1)
    deep = m1 > m0
    return s0, [torch.where(deep, a, b) for a, b in zip(s1, s0)]


# ------------------------------------------------- bc7-resident sampling


def _bc7_row_words(row, n: int = 8) -> list:
    """(..., 128) u8 bc7 rows → for each of the first ``n`` of the 8
    baked blocks (0-3 the child group, 4-7 the parent group) its four
    words, int64 tensors (...,), kept unstacked."""
    u = row.to(torch.int64)
    return [bcn.le_words(u, 16 * s, 4) for s in range(n)]


def _bc7_row_hints(hrow, n: int = 8) -> list:
    """(..., 64) u8 hint rows (``bcn.bc7_block_hints`` in the bc1 pool's
    group geometry) → for each of the first ``n`` baked blocks its
    (subset_word, anchors) pair of int64 tensors (...,)."""
    u = hrow.to(torch.int64)
    return [tuple(bcn.le_words(u, 8 * s, 2)) for s in range(n)]


def _bc7_pick(vals, base: int, sx, sy) -> list:
    """The tap's block's data from a 2x2 group (``vals``: per block a
    list of tensors, the group at base..base+3; sx/sy {0, 1} tensors or
    None where statically 0): ``_bc1_quad``'s pick over each tensor."""
    def sel(cond, a, b):
        return [torch.where(cond, x, y) for x, y in zip(a, b)]

    if sx is None and sy is None:
        return list(vals[base])
    if sy is None:
        return sel(sx == 1, vals[base + 1], vals[base])
    if sx is None:
        return sel(sy == 1, vals[base + 2], vals[base])
    lo = sel(sx == 1, vals[base + 1], vals[base])
    hi = sel(sx == 1, vals[base + 3], vals[base + 2])
    return sel(sy == 1, hi, lo)


def _bc7_quad(words, hints, base: int, taps, modes):
    """The 2x2 bilinear footprint decoded from a baked 2x2 BC7 block
    group: four single-texel decodes of the modes ``modes``
    (``bcn.bc7_texel_device``) at ``taps`` (as in ``_bc1_quad``). Returns
    (..., 16) i32 texels, corner-major RGBA like a quad row."""
    texels = []
    for xt, yt, sx, sy in taps:
        h = _bc7_pick(hints, base, sx, sy) if hints is not None else None
        texels += bcn.bc7_texel_device(_bc7_pick(words, base, sx, sy),
                                       (yt & 3) * 4 + (xt & 3), modes=modes,
                                       hint=h)
    return torch.stack(texels, -1)


def _bc7_trilinear_fused(pool, aux, modes, off0, hm0, wm0, hm1, wm1, m0, m1,
                         u, v):
    """Both levels of a trilinear tap from one 128 B bc7 row (and, where
    ``modes`` holds a partitioned mode, the block's 64 B hint row from
    ``aux``) and eight BC7 texel decodes → (s0, s1) channel lists:
    ``_bc1_trilinear_fused``'s group addressing at 16 B blocks. The
    decoded integers equal ``decode_bc7``'s and the same
    ``_contract_quad`` runs, so the result equals a pool of the decoded
    chains bit for bit."""
    x0c, y0c, x1c, y1c, fx, fy = _footprint(wm0, hm0, u, v)
    bx = x0c >> 2
    by = y0c >> 2
    idx = off0 + by * ((wm0 + 3) >> 2) + bx
    words = _bc7_row_words(_pool_rows(pool, idx, 128))
    hints = (_bc7_row_hints(_pool_rows(aux, idx, 64))
             if _bc7_needs_hint(modes) else None)
    rx = ((x1c >> 2) - bx).clamp(0, 1)
    ry = ((y1c >> 2) - by).clamp(0, 1)
    s0 = _contract_quad(_bc7_quad(
        words, hints, 0, [(x0c, y0c, None, None), (x1c, y0c, rx, None),
                          (x0c, y1c, None, ry), (x1c, y1c, rx, ry)], modes),
        fx, fy)
    xp0, yp0, xp1, yp1, fx1, fy1 = _footprint(wm1, hm1, u, v)
    ax = torch.minimum(((2 * bx - 1) >> 2).clamp(min=0),
                       (((wm1 + 3) >> 2) - 1).clamp(min=0))
    ay = torch.minimum(((2 * by - 1) >> 2).clamp(min=0),
                       (((hm1 + 3) >> 2) - 1).clamp(min=0))
    sx0 = ((xp0 >> 2) - ax).clamp(0, 1)
    sx1 = ((xp1 >> 2) - ax).clamp(0, 1)
    sy0 = ((yp0 >> 2) - ay).clamp(0, 1)
    sy1 = ((yp1 >> 2) - ay).clamp(0, 1)
    s1 = _contract_quad(_bc7_quad(
        words, hints, 4, [(xp0, yp0, sx0, sy0), (xp1, yp0, sx1, sy0),
                          (xp0, yp1, sx0, sy1), (xp1, yp1, sx1, sy1)], modes),
        fx1, fy1)
    deep = m1 > m0
    return s0, [torch.where(deep, a, b) for a, b in zip(s1, s0)]


# ------------------------------------- the bc7 trilinear sample (a hand kernel)


def bc7_trilinear_reference(pool, aux, off0, th, tw, lod, u, v,
                            num_mips: int, modes) -> torch.Tensor:
    """Plain PyTorch version of ``bc7_trilinear``, same contract: the
    levels (``_levels``), the level-m0 block row (``_mip_arith_bc1``),
    ``_bc7_trilinear_fused``'s eight decodes of every listed mode in
    int64 ops, and the lerp between the levels."""
    _check_bc7_args(pool, aux, off0, th, tw, lod, u, v, num_mips, modes)
    fm, m0, m1, hm1, wm1 = _levels(th, tw, lod, num_mips)
    off_a, hm0, wm0 = _mip_arith_bc1(off0, th, tw, m0, num_mips)
    s0, s1 = _bc7_trilinear_fused(pool, aux, tuple(modes),
                                  off_a, hm0, wm0, hm1, wm1, m0, m1, u, v)
    return torch.stack([a * (1 - fm) + b * fm for a, b in zip(s0, s1)])


def _check_bc7_args(pool, aux, off0, th, tw, lod, u, v, num_mips, modes):
    if (pool.dtype != torch.uint8 or pool.dim() != 2
            or pool.shape[1] != 128 or pool.shape[0] < 1):
        raise ValueError(f"pool must be u8 (rows >= 1, 128), got "
                         f"{pool.dtype} {tuple(pool.shape)}")
    if _bc7_needs_hint(modes) and (
            aux is None or aux.dtype != torch.uint8 or aux.dim() != 2
            or aux.shape[1] != 128 or aux.shape[0] < 1):
        raise ValueError("a partitioned BC7 mode needs the hint pool: aux "
                         "u8 (rows >= 1, 128)")
    n = off0.shape
    for name, x, dt in (("off0", off0, torch.int32), ("th", th, torch.int32),
                        ("tw", tw, torch.int32), ("lod", lod, torch.float32),
                        ("u", u, torch.float32), ("v", v, torch.float32)):
        if x.dtype != dt or x.dim() != 1 or x.shape != n:
            raise ValueError(f"{name} must be {dt} {tuple(n)} (1-D), "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != pool.device:
            raise ValueError(f"{name} on {x.device}, pool on {pool.device}")
    if not 1 <= num_mips <= 31 or not set(modes) <= set(range(8)):
        raise ValueError(f"num_mips {num_mips} not in [1, 31] or modes "
                         f"{tuple(modes)} not BC7 modes")


_BC7_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_uint] + [ctypes.c_void_p] * 7 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _bc7_trilinear_cuda(pool, aux, off0, th, tw, lod, u, v, num_mips: int,
                        modes) -> torch.Tensor:
    """``csrc/bc7_trilinear.cu`` on CUDA tensors, one thread a tap; counts
    ``bc7_trilinear.launches`` and, under a profiler, the taps in
    ``bc7.kernel_taps``."""
    _check_bc7_args(pool, aux, off0, th, tw, lod, u, v, num_mips, modes)
    # the kernel reads aux only for a listed partitioned mode, which the
    # check holds to a hint pool: without one the pool stands in
    aux = pool if aux is None else aux
    dev = pool.device
    for name, x in (("pool", pool), ("aux", aux)):
        if x.device != dev or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned "
                             f"and on {dev}")
    taps = [x.contiguous() for x in (off0, th, tw, lod, u, v)]
    n = taps[0].shape[0]
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    fn = _build.fn("bc7_trilinear", "mtr_bc7_trilinear", _BC7_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pool.data_ptr(), pool.shape[0], aux.data_ptr(),
                 aux.numel() // 64, sum(1 << m for m in set(modes)),
                 *(x.data_ptr() for x in taps), out.data_ptr(), n, num_mips,
                 stream)
    if err != 0:
        raise RuntimeError(f"bc7_trilinear kernel launch failed: cudaError "
                           f"{err}")
    bc7_trilinear.launches += 1
    count("bc7.kernel_taps", n)
    return out


# The sample as a ``torch.library`` op, as K1 is (``raster.K1_OPS``): a
# served program of a bc7 scene holds it as one node and dispatches as
# eager code does, the plain version on the CPU, the hand kernel on CUDA.
BC7_OP = torch.library.custom_op(
    "mtr::bc7_trilinear", bc7_trilinear_reference, mutates_args=(),
    device_types="cpu",
    schema=("(Tensor pool, Tensor? aux, Tensor off0, Tensor th, Tensor tw, "
            "Tensor lod, Tensor u, Tensor v, int num_mips, int[] modes) "
            "-> Tensor"))
BC7_OP.register_kernel("cuda")(_bc7_trilinear_cuda)


@BC7_OP.register_fake
def _bc7_op_fake(pool, aux, off0, th, tw, lod, u, v, num_mips, modes):
    return lod.new_empty((4, lod.shape[0]))


def bc7_trilinear(pool, aux, off0, th, tw, lod, u, v, num_mips: int,
                  modes) -> list:
    """Trilinear sample of a bc7 pool at taps of any (broadcast) shape →
    4 channel tensors f32 of that shape: ``pool`` (rows, 128) u8 (8 BC7
    blocks a row, ``_build_bc7_pool``), ``aux`` its hint pool (read only
    where ``modes`` holds a partitioned mode; None otherwise), ``off0``,
    ``th``, ``tw`` each texture's mip-0 block-row offset and extents,
    ``lod``, ``u``, ``v`` the tap; ``modes`` the BC7 modes decoded (a
    block of another mode is zeros).

    Runs the op ``mtr::bc7_trilinear`` on the taps flattened: a CPU
    tensor the plain ``bc7_trilinear_reference``, a CUDA tensor the hand
    kernel ``csrc/bc7_trilinear.cu`` (counted in
    ``bc7_trilinear.launches``), or raises."""
    shape = torch.broadcast_shapes(off0.shape, th.shape, tw.shape, lod.shape,
                                   u.shape, v.shape)
    taps = [x.expand(shape).reshape(-1).to(dt) for x, dt in (
        (off0, torch.int32), (th, torch.int32), (tw, torch.int32),
        (lod, torch.float32), (u, torch.float32), (v, torch.float32))]
    out = BC7_OP(pool, aux if _bc7_needs_hint(modes) else None, *taps,
                 num_mips, sorted(set(modes)))
    return list(out.reshape((4,) + tuple(shape)).unbind(0))


bc7_trilinear.launches = 0


def shade_mip_tap_flat_channels(scene: DeviceScene, mattrs, ib,
                                tap_tiles: int | None = None):
    """Tile-major trilinear shade of ``raster_fwd(mode="mtap")``'s
    outputs (mattrs (n_tiles, 17, P), ib (n_tiles, 1, P)) → (src
    channels [r, g, b, a] each (n_tiles, P) f32 0-255, covered
    (n_tiles, P) bool, n_over_tap).

    ``tap_tiles`` compacts the trilinear work to that many live
    (textured and covered) SEG_PX-px rows, sized as for the bilinear tap
    (``auto_tap_tiles``); None/0 = every row. Dense and compacted run the
    one code path (gather the live rows first, trilinear, scatter back),
    so they agree bit for bit; rows over the cap lose their texture and
    are counted in n_over_tap."""
    covered = ib[:, 0, :] >= 0
    textured = mattrs[:, 2, :] >= 0.0
    nt, _, p = mattrs.shape
    n = nt * (p // SEG_PX)
    cap = min(tap_tiles, n) if tap_tiles else n
    live = (covered & textured).reshape(n, SEG_PX).any(1)
    src_rows, slot, n_over_tap = _compact_live_rows(live, cap)
    albc = _mip_albedo_channels(scene, _seg_rows(mattrs)[src_rows.long()])
    alb = [a.reshape(nt, p) for a in _expand_rows(albc, slot, n)]
    src = [torch.where(textured, alb[c] * mattrs[:, 7 + c, :],
                       mattrs[:, 7 + c, :]) for c in range(4)]
    return src, covered, n_over_tap


def composite_peeled_mip_flat(scene: DeviceScene, mattrs, il, layers: int,
                              clear_color, tap_tiles: int | None = None,
                              covered=None, dst0=None):
    """Tile-major multi-layer trilinear composite over ``raster_fwd_ml(
    mode="mtap")``'s outputs (mattrs (n_tiles, 17L, P), il (n_tiles, L,
    P), nearest layer first): the mip twin of ``composite_peeled_tap_flat``.
    The trilinear shade runs on the live (textured and covered) SEG_PX-px
    (tile, layer) rows through the one code path of
    ``shade_mip_tap_flat_channels`` (gather the live rows, trilinear,
    scatter back), so ``tap_tiles`` None/0 (every row) and a cap agree
    bit for bit; rows over the cap lose their texture and are counted in
    n_over_tap. The layers blend back to front with src-alpha.
    ``covered`` and ``dst0`` as in the tap version (the split peel's
    behind-opaque cull and opaque base).

    Returns (channels [r, g, b, a] each (n_tiles, P) f32 0-255, still
    tile-major, n_over_tap)."""
    nt, _, p = mattrs.shape
    a4 = mattrs.reshape(nt, layers, rs.ATTRS_MTAP, p)
    if covered is None:
        covered = il >= 0
    textured = a4[:, :, 2] >= 0.0
    n = nt * layers * (p // SEG_PX)
    cap = min(tap_tiles, n) if tap_tiles else n
    live = (covered & textured).reshape(n, SEG_PX).any(1)
    src_rows, slot, n_over_tap = _compact_live_rows(live, cap)
    albc = _mip_albedo_channels(scene, _seg_rows(
        a4.reshape(nt * layers, rs.ATTRS_MTAP, p))[src_rows.long()])
    alb = [a.reshape(nt, layers, p) for a in _expand_rows(albc, slot, n)]
    if dst0 is None:
        clear = np.asarray(clear_color, np.float32)
        dst = [torch.full((nt, p), float(clear[c]), device=il.device)
               for c in range(4)]
    else:
        dst = list(dst0)
    for layer in reversed(range(layers)):
        src = [torch.where(textured[:, layer],
                           alb[c][:, layer] * a4[:, layer, 7 + c],
                           a4[:, layer, 7 + c]) for c in range(4)]
        dst = blend_over_planes(src, covered[:, layer], dst)
    return dst, n_over_tap


# ------------------------------------------------------- multipass peel


def shade_fwd(scene: DeviceScene, attrs, ib, mipmap: bool = False,
              lighting: bool = False):
    """Shade from K1's plain-attributes planes (``raster_fwd(mode=
    "attrs")``: attrs (n, 18 or 21 lit, X), ib (n, X)) → (src channels
    [r, g, b, a] each (n, X) f32 0-255, covered (n, X) bool); elementwise
    per pixel, so tile-major in, tile-major out.

    Perspective u, v from the u/w, v/w and 1/w planes; the albedo is the
    bilinear tap of mip 0 at the winner's off/th/tw columns, or with
    ``mipmap`` the trilinear tap (``_trilinear_arith``, any pool) at the
    analytic LOD of the winner's U/V/Q gradients divided by Q here (the
    reference's ``device.shade_fwd``). ``lighting`` scales rgb by the
    lambert factor of the normal planes: n = [nx, ny, nz]/w x w,
    normalised, 0.3 + 0.7 max(n.l, 0); its square root runs in f64 (see
    ``raster._lit_scale``)."""
    covered = ib >= 0
    w_ = attrs[:, 2]
    inv = torch.reciprocal(torch.where(w_.abs() < W_EPS, W_EPS, w_))
    u = attrs[:, 0] * inv
    v = attrs[:, 1] * inv
    textured = rs._trunc_i32(attrs[:, 3]) >= 0
    off = rs._trunc_i32(attrs[:, 8]) * 4096 + rs._trunc_i32(attrs[:, 9])
    th = rs._trunc_i32(attrs[:, 10])
    tw = rs._trunc_i32(attrs[:, 11])
    if mipmap:
        g0 = attrs.shape[1] - 6
        lod = _analytic_lod(u, v, *[attrs[:, g0 + i] * inv
                                    for i in range(6)],
                            attrs[:, 10], attrs[:, 11])
        albedo = _trilinear_arith(scene.mip_pool, off, th, tw, lod, u, v,
                                  scene.num_mips, mode=scene.pool_mode,
                                  aux=scene.aux_pool,
                                  bc7_modes=scene.bc7_modes)
    else:
        albedo = _quad_bilinear(scene.mip_pool, off, th, tw, u, v)
    src = [torch.where(textured, albedo[c] * attrs[:, 4 + c],
                       attrs[:, 4 + c]) for c in range(4)]
    if lighting:
        n = [attrs[:, 12 + i] * inv for i in range(3)]
        ln = torch.sqrt((n[0] * n[0] + n[1] * n[1] + n[2] * n[2]).to(
            torch.float64)).to(torch.float32).clamp(min=1e-6)
        n = [c / ln for c in n]
        light = _light_unit()
        ndl = (light[0] * n[0] + light[1] * n[1] + light[2] * n[2]).clamp(
            min=0.0)
        shade = 0.3 + 0.7 * ndl
        src = [src[0] * shade, src[1] * shade, src[2] * shade, src[3]]
    return src, covered


def blend_over_planes(src, covered, dst) -> list:
    """src-alpha over ``dst``, channel lists [r, g, b, a] of one shape;
    output alpha is src alpha (the reference blend state); ``dst`` where
    not ``covered``."""
    a = src[3] / 255.0
    return ([torch.where(covered, src[c] * a + dst[c] * (1.0 - a), dst[c])
             for c in range(3)]
            + [torch.where(covered, src[3], dst[3])])


def _multipass_flat(scene: DeviceScene, cols, bbox, *, pw: int, ph: int,
                    layers: int, maxc: int, clear_color, mipmap: bool,
                    light, raster=rs.raster_fwd):
    """The multipass peel over the whole padded frame: bin once, then
    ``layers`` passes of K1, each excluding every depth at or in front of
    the previous pass's winner + PEEL_EPS (``zlow``; +inf where the
    previous pass covered nothing, so nothing enters there). Each pass
    shades: the tap epilogue and the dense ``shade_tap_flat_channels``,
    or with ``mipmap`` the attrs epilogue and ``shade_fwd`` (lit under
    ``light``); then the passes blend back to front over the clear color.

    Returns (channels [r, g, b, a] each (n_tiles, P) f32 tile-major, z of
    the first pass (n_tiles, P) with 1.0 where empty, the bins' overflow
    count)."""
    lists, glists, counts, n_over = rs.prebin(cols, bbox, 0, 0, width=pw,
                                              height=ph, maxc=maxc)
    kw = dict(width=pw, height=ph, w_eps=W_EPS, light=light)
    passes = []
    zlow = None
    for _ in range(layers):
        if mipmap:
            zb, ib, attrs = raster(cols, lists, glists, counts, (0, 0),
                                   mode="attrs", zlow=zlow, **kw)
            src, covered = shade_fwd(scene, attrs, ib[:, 0], mipmap=True,
                                     lighting=light is not None)
        else:
            zb, ib, tattrs, tapidx = raster(cols, lists, glists, counts,
                                            (0, 0), zlow=zlow, **kw)
            src, covered, _ = shade_tap_flat_channels(scene, tattrs, tapidx,
                                                      ib)
        passes.append((src, covered, zb[:, 0]))
        zlow = torch.where(ib >= 0, zb + PEEL_EPS, float("inf"))
    clear = np.asarray(clear_color, np.float32)
    dst = [torch.full_like(passes[0][2], float(clear[c])) for c in range(4)]
    for src, covered, _ in reversed(passes):
        dst = blend_over_planes(src, covered, dst)
    return dst, passes[0][2], n_over


# ------------------------------------------------------- bilinear SWAR (K4)


def _swar_lerp(t0, t1, w):
    """Lerp of two packed RGBA8 words (int64 holding u32 bits) with an
    integer weight w in 0..256, two 8-bit fields per half word, rounded
    to nearest."""
    m = 0x00FF00FF
    rb = ((t0 & m) * (256 - w) + (t1 & m) * w + 0x00800080) >> 8
    ga = (((t0 >> 8) & m) * (256 - w) + ((t1 >> 8) & m) * w
          + 0x00800080) >> 8
    return (rb & m) | ((ga & m) << 8)


def _weight8(f):
    """trunc(clip(f * 256 + 0.5, 0, 256)): the 8-bit SWAR weight."""
    return rs._trunc_i32((f * 256.0 + 0.5).clamp(0.0, 256.0)).to(torch.int64)


def _check_swar_args(pool_u32, idx, fx, fy):
    if (pool_u32.dtype != torch.int32 or pool_u32.dim() != 2
            or pool_u32.shape[1] != 4 or pool_u32.shape[0] < 1):
        raise ValueError(f"pool_u32 must be i32 (npool >= 1, 4), got "
                         f"{pool_u32.dtype} {tuple(pool_u32.shape)}")
    n = idx.shape
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"idx must be i32 (n,), got {idx.dtype} {tuple(n)}")
    for name, f in (("fx", fx), ("fy", fy)):
        if f.dtype != torch.float32 or f.shape != n:
            raise ValueError(f"{name} must be f32 {tuple(n)}, got {f.dtype} "
                             f"{tuple(f.shape)}")
    for x in (idx, fx, fy):
        if x.device != pool_u32.device:
            raise ValueError(f"inputs on {x.device} and {pool_u32.device}")


_SWAR_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_void_p]


def bilin_swar(pool_u32, idx, fx, fy):
    """The SWAR bilinear filter of quad-pool rows (kernel K4, the
    counterpart of ``tools/bench/bilin_ab.py::run_swar_pl``):
    ``pool_u32`` (npool, 4) i32 holds each quad row's four RGBA8 texels
    as u32 bits (``scene.mip_pool.view(torch.int32)``), ``idx`` (n,) i32
    the rows (clamped to [0, npool - 1], as JAX's gather clamps), ``fx``
    and ``fy`` (n,) f32 the tap fractions. Returns (n,) i32 holding the
    filtered RGBA8 as u32 bits (r | g << 8 | b << 16 | a << 24), each
    channel the 8-bit-weight lerp rounded to nearest.

    A CPU tensor runs ``bilin_swar_reference``. A CUDA tensor launches
    ``csrc/bilin_swar.cu``, the row gather fused (counted in
    ``bilin_swar.launches``), or raises."""
    _check_swar_args(pool_u32, idx, fx, fy)
    dev = pool_u32.device
    if dev.type == "cpu":
        return bilin_swar_reference(pool_u32, idx, fx, fy)
    if dev.type != "cuda":
        raise ValueError(f"bilin_swar runs on CPU or CUDA, not {dev}")
    fn = _build.fn("bilin_swar", "mtr_bilin_swar", _SWAR_ARGS)
    pool_u32, idx, fx, fy = (x.contiguous() for x in (pool_u32, idx, fx, fy))
    out = torch.empty(idx.shape, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pool_u32.data_ptr(), pool_u32.shape[0], idx.data_ptr(),
                 fx.data_ptr(), fy.data_ptr(), out.data_ptr(), idx.shape[0],
                 stream)
    if err != 0:
        raise RuntimeError(f"bilin_swar kernel launch failed: cudaError {err}")
    bilin_swar.launches += 1
    return out


bilin_swar.launches = 0


def bilin_swar_reference(pool_u32, idx, fx, fy):
    """Plain PyTorch version of ``bilin_swar``, same contract: the row
    gather, then the field arithmetic in int64 on the u32 bits."""
    _check_swar_args(pool_u32, idx, fx, fy)
    rows = idx.clamp(0, pool_u32.shape[0] - 1).long()
    q = pool_u32[rows].to(torch.int64) & 0xFFFFFFFF        # (n, 4)
    wx, wy = _weight8(fx), _weight8(fy)
    out = _swar_lerp(_swar_lerp(q[:, 0], q[:, 1], wx),
                     _swar_lerp(q[:, 2], q[:, 3], wx), wy)
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


# ------------------------------------------------------- host predictors


def _padded(width: int, height: int) -> tuple[int, int]:
    return (-(-width // rs.TILE_W) * rs.TILE_W,
            -(-height // rs.TILE_H) * rs.TILE_H)


def _chunk_bboxes(batch, view_proj, bone_mats=None, *,
                  width: int, height: int):
    """Per-chunk screen bboxes + textured flag (xmin, xmax, ymin, ymax
    (C,) f32, textured (C,) bool), in NumPy from the host batch: mirrors
    ``upload``'s padding and the group bboxes of ``setup_packed_cols``
    at chunk granularity."""
    pos = cr.skin_positions(batch, bone_mats)
    homo = np.concatenate([pos, np.ones((len(pos), 1), np.float32)], axis=1)
    clip = homo @ np.asarray(view_proj, np.float32).T
    c = clip[batch.tris]                              # (T, 3, 4)
    w = c[..., 3]
    ndc = c[..., :3] / np.where(np.abs(w) < W_EPS, W_EPS, w)[..., None]
    sx = (ndc[..., 0] + 1.0) * (0.5 * width)
    sy = (1.0 - ndc[..., 1]) * (0.5 * height)
    area2 = (sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0]) - (
        sy[:, 1] - sy[:, 0]) * (sx[:, 2] - sx[:, 0])
    valid = (w > W_EPS).all(axis=1) & (area2 < 0.0)

    t = len(batch.tris)
    tp = max(TRI_PAD, -(-t // TRI_PAD) * TRI_PAD)
    big = np.float32(1e30)
    xmin = np.full(tp, big, np.float32)
    xmax = np.full(tp, -big, np.float32)
    ymin = np.full(tp, big, np.float32)
    ymax = np.full(tp, -big, np.float32)
    xmin[:t] = np.where(valid, sx.min(1), big)
    xmax[:t] = np.where(valid, sx.max(1), -big)
    ymin[:t] = np.where(valid, sy.min(1), big)
    ymax[:t] = np.where(valid, sy.max(1), -big)
    cc = tp // rs.CT
    tex = np.full(tp, -1, np.int32)
    tex[:t] = batch.tri_texture
    return (xmin.reshape(cc, rs.CT).min(1),
            xmax.reshape(cc, rs.CT).max(1),
            ymin.reshape(cc, rs.CT).min(1),
            ymax.reshape(cc, rs.CT).max(1),
            (tex.reshape(cc, rs.CT) >= 0).any(1))


def predict_bin_counts(batch, view_proj, bone_mats=None, *,
                       width: int, height: int, y0: int = 0,
                       grid_rows: int | None = None) -> np.ndarray:
    """NumPy mirror of ``raster.bin_chunks``: per-tile candidate-chunk
    counts (n_ty, n_tx) for this view, computed from the host batch with
    no device work. ``y0``/``grid_rows``: bin against a band's own tile
    grid (its origin row and padded row count) while the screen
    transform keeps the full frame's height, as the band split renders."""
    pw, ph = _padded(width, height)
    xmin, xmax, ymin, ymax, _ = _chunk_bboxes(
        batch, view_proj, bone_mats, width=width, height=height)
    n_ty, n_tx = (grid_rows or ph) // rs.TILE_H, pw // rs.TILE_W
    ty0 = np.arange(n_ty, dtype=np.float32) * rs.TILE_H + y0
    tx0 = np.arange(n_tx, dtype=np.float32) * rs.TILE_W
    ovy = (ymax[:, None] >= ty0) & (ymin[:, None] <= ty0 + rs.TILE_H)
    ovx = (xmax[:, None] >= tx0) & (xmin[:, None] <= tx0 + rs.TILE_W)
    return (ovy[:, :, None] & ovx[:, None, :]).sum(axis=0)


def predict_live_rows(batch, view_proj, bone_mats=None, *,
                      width: int, height: int, y0: int = 0,
                      grid_rows: int | None = None) -> int:
    """Host upper bound on live SEG_PX-px tap rows for this view: a row
    can only be textured and covered if a textured chunk's bbox
    overlaps it. ``y0``/``grid_rows`` as in ``predict_bin_counts``."""
    pw, ph = _padded(width, height)
    xmin, xmax, ymin, ymax, tex = _chunk_bboxes(
        batch, view_proj, bone_mats, width=width, height=height)
    xmin, xmax = xmin[tex], xmax[tex]
    ymin, ymax = ymin[tex], ymax[tex]
    seg_h = SEG_PX // rs.TILE_W     # pixel rows per compaction segment
    n_tx = pw // rs.TILE_W
    tx0 = np.arange(n_tx, dtype=np.float32) * rs.TILE_W
    ys = (np.arange((grid_rows or ph) // seg_h, dtype=np.float32) * seg_h
          + y0)
    ovx = (xmax[:, None] >= tx0) & (xmin[:, None] <= tx0 + rs.TILE_W)
    ovy = (ymax[:, None] >= ys) & (ymin[:, None] <= ys + float(seg_h))
    live = (ovy.astype(np.float32).T @ ovx.astype(np.float32)) > 0.0
    return int(live.sum())


def auto_maxc(batch, view_proj, bone_mats=None, *,
              width: int, height: int, margin: float = 1.5) -> int:
    """Size the binning cap for a scene: the densest tile's true
    candidate-chunk count for this view, with ``margin`` headroom for
    animation, rounded up to a multiple of 8."""
    need = int(predict_bin_counts(batch, view_proj, bone_mats,
                                  width=width, height=height).max())
    return max(8, -(-int(np.ceil(need * margin)) // 8) * 8)


def band_rows(height: int, bands: int) -> tuple[int, int]:
    """(rows per band, padded rows per band) of a ``bands``-way band
    split: ceil(height / bands) rows, padded to whole tiles."""
    band_h = -(-height // bands)
    return band_h, -(-band_h // rs.TILE_H) * rs.TILE_H


def _seg_rows_of(pw: int, ph: int) -> int:
    """SEG_PX-px tap rows of a padded ``pw`` x ``ph`` grid."""
    return (pw // rs.TILE_W) * (ph // (SEG_PX // rs.TILE_W))


def auto_tap_tiles(batch, view_proj, bone_mats=None, *,
                   width: int, height: int, margin: float = 1.25,
                   bands: int = 1) -> int:
    """Host-side cap for the compacted texture tap, in SEG_PX-px rows:
    ``predict_live_rows`` x ``margin``, rounded up to a multiple of 8
    and clamped to the grid's row count. ``bands`` > 1 sizes a band
    split (``parallel.tiles``): the maximum over each band's own tile
    grid, so that one cap serves every band."""
    pw, _ = _padded(width, height)
    band_h, pb = band_rows(height, bands)
    live = max(predict_live_rows(batch, view_proj, bone_mats, width=width,
                                 height=height, y0=i * band_h, grid_rows=pb)
               for i in range(bands))
    return min(max(8, -(-int(np.ceil(live * margin)) // 8) * 8),
               _seg_rows_of(pw, pb))


# ------------------------------------------------ the cap guard, on device


def guard_counts(scene: DeviceScene, view_proj, bone_mats=None, *,
                 width: int, height: int) -> torch.Tensor:
    """The cap guard's two counts for this view, on the scene's device →
    (2,) int32: [0] the bin need, the frame's largest per-tile
    candidate-chunk count (``raster.bin_chunks``' ``counts_true.max()``
    on the frame's own group boxes: exact, not a prediction); [1] an
    upper bound on the live SEG_PX-px tap rows, the rows (one tile each:
    SEG_PX is a tile's pixels) that a group holding a valid textured
    triangle overlaps.

    The frame's own vertex stage (a palette on the device stays there)
    and screen transform (``_screen``), the group boxes of
    ``setup_packed_cols``, and no setup rows. Nothing is read back: the
    caller reads both counts in one transfer."""
    pw, ph = _padded(width, height)
    clip = vertex_stage(scene, view_proj, bone_mats)
    _, _, sx, sy, _, valid = _screen(scene, clip, width, height)
    xmin, xmax = _group_min(sx, valid), _group_max(sx, valid)
    ymin, ymax = _group_min(sy, valid), _group_max(sy, valid)
    dev = xmin.device
    ty0 = torch.arange(ph // rs.TILE_H, dtype=torch.float32,
                       device=dev) * rs.TILE_H
    tx0 = torch.arange(pw // rs.TILE_W, dtype=torch.float32,
                       device=dev) * rs.TILE_W
    ovy = (ymax[:, None] >= ty0) & (ymin[:, None] <= ty0 + rs.TILE_H)
    ovx = (xmax[:, None] >= tx0) & (xmin[:, None] <= tx0 + rs.TILE_W)
    ov = ovy[:, :, None] & ovx[:, None, :]           # (groups, n_ty, n_tx)
    need = ov.reshape(-1, rs.G, ov.shape[1] * ov.shape[2]).any(1).sum(
        0, dtype=torch.int32).amax()
    textured = (valid & (scene.cols_const[0] >= 0.0)).reshape(
        -1, rs.KG).any(1)
    rows = (ov & textured[:, None, None]).any(0).sum(dtype=torch.int32)
    return torch.stack([need, rows])


# --------------------------------------------------------------- scan backend
#
# The reference's second renderer and its independent oracle: every
# triangle against every pixel, DEFAULT_CHUNK triangles a step, z from
# barycentrics and the shade from per-triangle tables (nothing of K1's
# planes or packed columns). Plain PyTorch: the reference's is plain XLA,
# with no Pallas kernel. It costs O(triangles x pixels).


def setup_stage(scene: DeviceScene, clip, width: int, height: int,
                bone_mats=None, need_normals: bool = False) -> dict:
    """Per-triangle setup of the scan backend → a dict of (Tp, ...)
    tensors: edge coefficients ea/eb/ec (Tp, 3), the top-left flags and
    snap bands, the area, NDC depth sz and 1/w per corner, validity,
    corner uvs (Tp, 3, 2) and, with ``need_normals``, the world normals
    (Tp, 3, 3) under ``bone_mats``."""
    c = clip.reshape(3, -1, 4).transpose(0, 1)            # (Tp, 3, 4)
    w = c[..., 3]
    inv_w = torch.reciprocal(torch.where(w.abs() < W_EPS, W_EPS, w))
    ndc = c[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] + 1.0) * (0.5 * width)              # (Tp, 3)
    sy = (1.0 - ndc[..., 1]) * (0.5 * height)
    area2 = (sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0]) - (
        sy[:, 1] - sy[:, 0]) * (sx[:, 2] - sx[:, 0])
    valid = scene.tri_vis & (w > W_EPS).all(1) & (area2 < 0.0)
    # edge i runs from corner i+1 to corner i+2; E = A px + B py + C is
    # positive inside a front face (cpu_reference's convention)
    ax = torch.stack([sx[:, 1], sx[:, 2], sx[:, 0]], 1)
    ay = torch.stack([sy[:, 1], sy[:, 2], sy[:, 0]], 1)
    bx = torch.stack([sx[:, 2], sx[:, 0], sx[:, 1]], 1)
    by = torch.stack([sy[:, 2], sy[:, 0], sy[:, 1]], 1)
    ea = by - ay
    eb = -(bx - ax)
    ec = ay * (bx - ax) - ax * (by - ay)
    out = dict(
        ea=ea, eb=eb, ec=ec,
        topleft=((ay == by) & (bx < ax)) | (by > ay),
        esnap=1e-6 * (ea.abs() * width + eb.abs() * height + ec.abs()),
        area=-area2, sz=ndc[..., 2], inv_w=inv_w, valid=valid,
        uv=scene.uvs.reshape(3, -1, 2).transpose(0, 1))
    if need_normals:
        out["nrm"] = world_normals(scene, bone_mats).reshape(
            3, -1, 3).transpose(0, 1)
    return out


def _coverage(ch: dict, px, py):
    """Edge coverage of a chunk of K triangles over a pixel grid (px, py
    (H, W)) → (cov (K, H, W) bool, e (K, 3, H, W)): |e| within the snap
    band counts as on the edge, where the top-left rule decides."""
    e = (ch["ea"][:, :, None, None] * px + ch["eb"][:, :, None, None] * py
         + ch["ec"][:, :, None, None])
    on_edge = e.abs() <= ch["esnap"][:, :, None, None]
    inside = (~on_edge & (e > 0.0)) | (on_edge
                                       & ch["topleft"][:, :, None, None])
    return inside.all(1) & ch["valid"][:, None, None], e


def _band_grid(width: int, height: int, origin, band, dev):
    """Pixel centers (px, py), each (bh, bw) f32, of the band ``band`` =
    (bw, bh) (default the frame) whose top-left pixel is ``origin``."""
    bw, bh = band if band is not None else (width, height)
    x0, y0 = (int(o) for o in origin)
    px = torch.arange(bw, dtype=torch.float32, device=dev) + (x0 + 0.5)
    py = torch.arange(bh, dtype=torch.float32, device=dev) + (y0 + 0.5)
    return px[None, :].expand(bh, bw), py[:, None].expand(bh, bw)


def _chunk_depth(ch: dict, px, py):
    """A chunk's (cov (K, H, W), z (K, H, W)): z = sum_i sz_i * bary_i."""
    cov, e = _coverage(ch, px, py)
    b = e * (1.0 / ch["area"])[:, None, None, None]
    sz = ch["sz"][:, :, None, None]
    return cov, sz[:, 0] * b[:, 0] + sz[:, 1] * b[:, 1] + sz[:, 2] * b[:, 2]


def _chunks(setup: dict, chunk: int):
    """The setup's triangle ranges of ``chunk`` → (ids (K,), their
    setup dict), in order."""
    tp = setup["ea"].shape[0]
    if tp % chunk:
        raise ValueError(f"{tp} triangles are not a multiple of chunk="
                         f"{chunk}")
    ids = torch.arange(tp, dtype=torch.int32, device=setup["ea"].device)
    for lo in range(0, tp, chunk):
        yield ids[lo:lo + chunk], {k: v[lo:lo + chunk]
                                   for k, v in setup.items()
                                   if k not in ("uv", "nrm")}


def raster_stage(setup: dict, width: int, height: int, chunk: int,
                 origin=(0, 0), band=None, zlow=None):
    """Scan over triangle chunks → per-pixel (depth (bh, bw) f32 with 1.0
    where uncovered, winner id (bh, bw) i32 or -1).

    Candidates are inside with 0 <= z <= the running depth (and z >
    ``zlow``, (bh, bw), when given); per chunk the nearest wins, the
    larger id on exact ties (the argmin of the reversed chunk: argmin
    returns the first minimum), and it replaces the running winner when
    at least as near: later triangles win ties, as in the ordered CPU
    path. ``origin``/``band`` select a screen rectangle; the viewport
    transform keeps the full ``width`` x ``height``."""
    px, py = _band_grid(width, height, origin, band, setup["ea"].device)
    zbest = torch.full(px.shape, float("inf"), device=px.device)
    ibest = torch.full(px.shape, -1, dtype=torch.int32, device=px.device)
    for ids, ch in _chunks(setup, chunk):
        cov, z = _chunk_depth(ch, px, py)
        zok = cov & (z <= zbest) & (z >= 0.0)
        if zlow is not None:
            zok &= z > zlow
        zr = torch.where(zok, z, float("inf")).flip(0)
        k = torch.argmin(zr, 0)
        zmin = torch.gather(zr, 0, k[None])[0]
        upd = (zmin <= zbest) & torch.isfinite(zmin)
        zbest = torch.where(upd, zmin, zbest)
        ibest = torch.where(upd, ids.flip(0)[k], ibest)
    return torch.where(ibest >= 0, zbest, 1.0), ibest


def raster_multilayer(setup: dict, width: int, height: int, chunk: int,
                      layers: int, origin=(0, 0), band=None):
    """Single-pass L-layer visibility: the ``layers`` nearest fragments
    per pixel in one scan over triangle chunks, each chunk's fragments
    merged into the running list sorted on (z ascending, id descending):
    a stable sort on the id, then a stable sort on z (the reference's
    two-key ``lax.sort``). Returns (z (L, bh, bw) with 1.0 beyond the
    last fragment, ids (L, bh, bw) i32 or -1), nearest first."""
    px, py = _band_grid(width, height, origin, band, setup["ea"].device)
    dev = px.device
    zl = torch.full((layers,) + px.shape, float("inf"), device=dev)
    il = torch.full((layers,) + px.shape, -1, dtype=torch.int32, device=dev)
    for ids, ch in _chunks(setup, chunk):
        cov, z = _chunk_depth(ch, px, py)
        zm = torch.where(cov & (z >= 0.0), z, float("inf"))
        allz = torch.cat([zl, zm])
        allid = torch.cat([il, ids[:, None, None].expand(zm.shape)])
        o = torch.sort(allid, dim=0, descending=True, stable=True).indices
        allz = torch.gather(allz, 0, o)
        allid = torch.gather(allid, 0, o)
        o = torch.sort(allz, dim=0, stable=True).indices[:layers]
        zl = torch.gather(allz, 0, o)
        il = torch.gather(allid, 0, o)
    il = torch.where(torch.isfinite(zl), il, -1)
    return torch.where(il >= 0, zl, 1.0), il


def _sample_mip_bilinear(pool, table, layer, mip, u, v) -> list:
    """Bilinear tap of texture ``layer``'s level ``mip`` (each like u)
    through the mip table (L, M, 3) → 4 channel tensors."""
    t = table.reshape(-1, 3)[(layer * table.shape[1] + mip).long()]
    return _quad_bilinear(pool, t[..., 0], t[..., 1], t[..., 2], u, v)


def _bc1_bilinear(pool, off, hh, ww, u, v) -> list:
    """Bilinear tap from the bc1 pool: one 64 B row, the block group at
    (x0c >> 2, y0c >> 2) whose baked 2x2 blocks hold the whole footprint,
    and four texel decodes. ``off`` is the level's block-row offset,
    hh/ww its texel extents."""
    x0c, y0c, x1c, y1c, fx, fy = _footprint(ww, hh, u, v)
    bx = x0c >> 2
    by = y0c >> 2
    row = _pool_rows(pool, off + by * ((ww + 3) >> 2) + bx, 64)
    c0s, c1s, bits = _bc1_words(row, n=4)
    rx = ((x1c >> 2) - bx).clamp(0, 1)
    ry = ((y1c >> 2) - by).clamp(0, 1)
    return _contract_quad(_bc1_quad(
        c0s, c1s, bits, 0, [(x0c, y0c, None, None), (x1c, y0c, rx, None),
                            (x0c, y1c, None, ry), (x1c, y1c, rx, ry)]),
        fx, fy)


def _bc7_bilinear(pool, aux, modes, off, hh, ww, u, v) -> list:
    """Bilinear tap from the bc7 pool: one 128 B row (and, where
    ``modes`` holds a partitioned mode, its 64 B hint row from ``aux``)
    and four texel decodes, addressed as ``_bc1_bilinear``."""
    x0c, y0c, x1c, y1c, fx, fy = _footprint(ww, hh, u, v)
    bx = x0c >> 2
    by = y0c >> 2
    idx = off + by * ((ww + 3) >> 2) + bx
    words = _bc7_row_words(_pool_rows(pool, idx, 128), n=4)
    hints = (_bc7_row_hints(_pool_rows(aux, idx, 64), n=4)
             if _bc7_needs_hint(modes) else None)
    rx = ((x1c >> 2) - bx).clamp(0, 1)
    ry = ((y1c >> 2) - by).clamp(0, 1)
    return _contract_quad(_bc7_quad(
        words, hints, 0, [(x0c, y0c, None, None), (x1c, y0c, rx, None),
                          (x0c, y1c, None, ry), (x1c, y1c, rx, ry)], modes),
        fx, fy)


def _level0(scene: DeviceScene, layer):
    """Texture ``layer``'s (clamped) mip-0 (offset, h, w) from the table."""
    lc = layer.clamp(0, scene.mip_table.shape[0] - 1).long()
    t = scene.mip_table[:, 0][lc]
    return t[..., 0], t[..., 1], t[..., 2]


def sample_bilinear(scene: DeviceScene, layer, u, v) -> list:
    """Bilinear clamp-to-edge tap of mip 0 of texture ``layer`` at (u,
    v) (each (...)) from any pool → 4 channel tensors f32 0-255."""
    if scene.pool_mode == "bc7":
        return _bc7_bilinear(scene.mip_pool, scene.aux_pool,
                             scene.bc7_modes, *_level0(scene, layer), u, v)
    if scene.pool_mode == "bc1":
        return _bc1_bilinear(scene.mip_pool, *_level0(scene, layer), u, v)
    lc = layer.clamp(0, scene.mip_table.shape[0] - 1)
    return _sample_mip_bilinear(scene.mip_pool, scene.mip_table, lc,
                                torch.zeros_like(lc), u, v)


def sample_trilinear(scene: DeviceScene, layer, u, v, lod) -> list:
    """Trilinear tap (bilinear at two levels, lerped by the fraction of
    ``lod``) of texture ``layer`` → 4 channel tensors. The tri, bc1 and
    bc7 pools take the fused one-gather sampler (``_trilinear_arith``,
    the expression every mipmapped path shares on such a pool); the quad
    and narrow pools two table-addressed bilinear taps."""
    if scene.pool_mode in ("bc1", "bc7") or scene.mip_pool.shape[-1] == 128:
        return _trilinear_arith(scene.mip_pool, *_level0(scene, layer), lod,
                                u, v, scene.num_mips, mode=scene.pool_mode,
                                aux=scene.aux_pool,
                                bc7_modes=scene.bc7_modes)
    lc = layer.clamp(0, scene.mip_table.shape[0] - 1)
    lod = lod.clamp(0.0, float(scene.num_mips - 1))
    m0 = rs._trunc_i32(torch.floor(lod))
    m1 = torch.clamp(m0 + 1, max=scene.num_mips - 1)
    fm = lod - m0.to(torch.float32)
    s0 = _sample_mip_bilinear(scene.mip_pool, scene.mip_table, lc, m0, u, v)
    s1 = _sample_mip_bilinear(scene.mip_pool, scene.mip_table, lc, m1, u, v)
    return [a * (1 - fm) + b * fm for a, b in zip(s0, s1)]


def _debug_palette(dev) -> torch.Tensor:
    """The 20 debug colors with alpha 255, (20, 4) f32."""
    return torch.as_tensor(np.concatenate(
        [DEBUG_PALETTE.astype(np.float32), np.full((20, 1), 255.0,
                                                  np.float32)], 1),
        device=dev)


def _dot3(a, b) -> torch.Tensor:
    """sum_i a[..., i] * b[..., i] over a last axis of 3, in order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def shade_src(scene: DeviceScene, setup: dict, ib, width: int, height: int,
              origin=(0, 0), band=None, mipmap: bool = False,
              lighting: bool = False):
    """Per-pixel source color of the winner ``ib`` (bh, bw) from the
    per-triangle tables → (src (bh, bw, 4) f32 0-255, covered (bh, bw)
    bool): barycentrics of the winner's edges at the pixel center,
    perspective-correct uv, the bilinear tap of mip 0 (or with ``mipmap``
    the trilinear tap at the analytic LOD of the winner's own U/V/Q
    planes, rebuilt from its edges), the flat or debug color where
    untextured, times the material color; ``lighting``: the lambert
    factor of the perspective-correct normal."""
    covered = ib >= 0
    idx = ib.clamp(min=0).long()
    px, py = _band_grid(width, height, origin, band, ib.device)
    ea = setup["ea"][idx]                                 # (H, W, 3)
    eb = setup["eb"][idx]
    area = setup["area"][idx][..., None]
    e = ea * px[..., None] + eb * py[..., None] + setup["ec"][idx]
    bw_ = (e / area) * setup["inv_w"][idx]                # bary / w
    pw = bw_[..., 0] + bw_[..., 1] + bw_[..., 2]
    uv = setup["uv"][idx]                                 # (H, W, 3, 2)
    u = _dot3(bw_, uv[..., 0]) / pw
    v = _dot3(bw_, uv[..., 1]) / pw
    layer = scene.tri_texture[idx]
    if mipmap:
        hw = scene.tex_size[layer.clamp(0, scene.tex_size.shape[0] - 1)
                            .long()].to(torch.float32)
        ax = (ea / area) * setup["inv_w"][idx]
        ay = (eb / area) * setup["inv_w"][idx]
        ipw = 1.0 / pw
        lod = _analytic_lod(
            u, v, _dot3(ax, uv[..., 0]) * ipw, _dot3(ay, uv[..., 0]) * ipw,
            _dot3(ax, uv[..., 1]) * ipw, _dot3(ay, uv[..., 1]) * ipw,
            (ax[..., 0] + ax[..., 1] + ax[..., 2]) * ipw,
            (ay[..., 0] + ay[..., 1] + ay[..., 2]) * ipw,
            hw[..., 0], hw[..., 1])
        albedo = sample_trilinear(scene, layer, u, v, lod)
    else:
        albedo = sample_bilinear(scene, layer, u, v)
    debug = _debug_palette(ib.device)[(scene.tri_debug_id[idx] % 20).long()]
    flat = scene.tri_flat[idx]
    untextured = torch.where(flat[..., 3:4] >= 0.0, flat, debug)
    src = torch.where((layer >= 0)[..., None], torch.stack(albedo, -1),
                      untextured)
    src = src * scene.mat_color[scene.tri_material[idx].long()]
    if lighting:
        nv = setup["nrm"][idx]                            # (H, W, 3, 3)
        n = torch.stack([_dot3(bw_, nv[..., c]) / pw for c in range(3)], -1)
        ln = torch.sqrt((n * n).sum(-1, keepdim=True).to(torch.float64)).to(
            torch.float32).clamp(min=1e-6)
        n = n / ln
        light = _light_unit()
        ndl = (light[0] * n[..., 0] + light[1] * n[..., 1]
               + light[2] * n[..., 2]).clamp(min=0.0)
        src = torch.cat([src[..., :3] * (0.3 + 0.7 * ndl)[..., None],
                         src[..., 3:]], -1)
    return src, covered


def blend_over(src, covered, dst):
    """src-alpha / one-minus-src-alpha over ``dst`` (..., 4); output alpha
    is src alpha (the reference blend state, model.rs:242-247); ``dst``
    where not ``covered``. Float 0-255."""
    a = src[..., 3:4] / 255.0
    out = torch.cat([src[..., :3] * a + dst[..., :3] * (1.0 - a),
                     src[..., 3:4]], -1)
    return torch.where(covered[..., None], out, dst)


def _to_u8(x):
    """Float 0-255 → uint8, rounding half up (clip(x + 0.5) truncated)."""
    return (x + 0.5).clamp(0.0, 255.0).to(torch.uint8)


def _clear(clear_color, shape, dev):
    return torch.as_tensor(np.asarray(clear_color, np.float32),
                           device=dev).expand(*shape, 4)


def shade_stage(scene: DeviceScene, setup: dict, zb, ib, width: int,
                height: int, clear_color, origin=(0, 0), band=None,
                mipmap: bool = False, lighting: bool = False):
    """Winner-takes-all deferred shading blended over the clear color →
    (bh, bw, 4) uint8."""
    src, covered = shade_src(scene, setup, ib, width, height, origin, band,
                             mipmap=mipmap, lighting=lighting)
    return _to_u8(blend_over(src, covered,
                             _clear(clear_color, ib.shape, ib.device)))


def _render_frame_scan(scene: DeviceScene, view_proj, bone_mats=None, *,
                       width: int, height: int, chunk: int,
                       clear_color: tuple, mipmap: bool = False,
                       lighting: bool = False, layers: int = 0):
    """The scan backend's frame → (color (H, W, 4) uint8, depth (H, W)
    f32): single-layer, or with ``layers`` the L nearest fragments of
    ``raster_multilayer``, each shaded by ``shade_src`` and blended back
    to front (depth: the nearest layer's)."""
    clip = vertex_stage(scene, view_proj, bone_mats)
    setup = setup_stage(scene, clip, width, height, bone_mats=bone_mats,
                        need_normals=lighting)
    if not layers:
        zb, ib = raster_stage(setup, width, height, chunk)
        return shade_stage(scene, setup, zb, ib, width, height, clear_color,
                           mipmap=mipmap, lighting=lighting), zb
    zl, il = raster_multilayer(setup, width, height, chunk, layers)
    dst = _clear(clear_color, il.shape[1:], il.device)
    for k in reversed(range(layers)):
        src, covered = shade_src(scene, setup, il[k], width, height,
                                 mipmap=mipmap, lighting=lighting)
        dst = blend_over(src, covered, dst)
    return _to_u8(dst), zl[0]


# ------------------------------------------------------------------ frame


def _single_layer_flat(scene: DeviceScene, cols, bbox, *, y0: int, pw: int,
                       ph: int, maxc: int | None, tap_tiles: int | None,
                       clear_color: tuple, mipmap: bool, light,
                       raster=rs.raster_fwd):
    """The single-layer frame's binning, raster and shade over one
    tile-aligned band of ``pw`` x ``ph`` px whose top row is ``y0`` (0
    and the whole padded frame for ``render_frame``; a band of
    ``parallel.tiles``), from the full frame's setup ``cols``/``bbox``
    → (packed (n_tiles, P) i32 and z (n_tiles, P) f32, both tile-major,
    (n_over, n_over_tap) device counts)."""
    with span("frame.prebin"):
        lists, glists, counts, n_over = rs.prebin(
            cols, bbox, 0, y0, width=pw, height=ph,
            maxc=maxc or rs.MAXC_DEFAULT)
    kw = dict(width=pw, height=ph, w_eps=W_EPS, light=light)
    if mipmap:
        with span("frame.raster"):
            zb, ib, mattrs = raster(cols, lists, glists, counts, (0, y0),
                                    mode="mtap", **kw)
        with span("frame.shade"):
            src, covered, n_over_tap = shade_mip_tap_flat_channels(
                scene, mattrs, ib, tap_tiles=tap_tiles)
            colort = _blend_pack_u32(src, covered, clear_color)
    else:
        with span("frame.raster"):
            zb, ib, tattrs, tapidx = raster(cols, lists, glists, counts,
                                            (0, y0), **kw)
        with span("frame.shade"):
            colort, _, n_over_tap = shade_finish_tap_flat(
                scene, tattrs, tapidx, ib, clear_color, tap_tiles=tap_tiles)
    return colort, zb[:, 0, :], (n_over, n_over_tap)


def _render_frame_core(scene: DeviceScene, view_proj, bone_mats=None, *,
                       width: int, height: int, clear_color: tuple,
                       maxc: int | None, tap_tiles: int | None,
                       mipmap: bool = False, lighting: bool = False,
                       raster=rs.raster_fwd):
    """Frame body → (packed color (H, W) i32, depth (H, W) f32,
    (n_over, n_over_tap) device counts). ``raster`` is the raster stage;
    passing ``raster.raster_fwd_reference`` renders the same frame
    through the plain version on any device."""
    pw, ph = _padded(width, height)
    with span("frame.vertex"):
        clip = vertex_stage(scene, view_proj, bone_mats)
    with span("frame.setup"):
        cols, bbox = setup_packed_cols(scene, clip, width, height,
                                       bone_mats=bone_mats, lighting=lighting)
    colort, zt, n_over = _single_layer_flat(
        scene, cols, bbox, y0=0, pw=pw, ph=ph, maxc=maxc,
        tap_tiles=tap_tiles, clear_color=clear_color, mipmap=mipmap,
        light=_light_unit() if lighting else None, raster=raster)
    with span("frame.unflatten"):
        color = rs.unflatten_tiles(colort, ph, pw)[:height, :width]
        depth = rs.unflatten_tiles(zt, ph, pw)[:height, :width]
        return color.contiguous(), depth.contiguous(), n_over


def count_covered_textured(scene: DeviceScene, view_proj, bone_mats=None,
                           *, width: int, height: int,
                           maxc: int | None = None):
    """Per-frame pixel counts on the scene's device → (covered,
    textured) i32 scalars: the pixels with a winner, and those whose
    winner's tap row is textured (``tapidx >= 0``, measured rather than
    assumed). One run of the production raster, K1 with its tap
    epilogue (the kernel on a CUDA device), at the binning cap ``maxc``;
    the counts stay on the device until the caller reads them."""
    pw, ph = _padded(width, height)
    clip = vertex_stage(scene, view_proj, bone_mats)
    cols, bbox = setup_packed_cols(scene, clip, width, height,
                                   bone_mats=bone_mats)
    lists, glists, counts, _ = rs.prebin(cols, bbox, 0, 0, width=pw,
                                         height=ph,
                                         maxc=maxc or rs.MAXC_DEFAULT)
    _, ib, _, tapidx = rs.raster_fwd(cols, lists, glists, counts, (0, 0),
                                     width=pw, height=ph, w_eps=W_EPS)
    cov = rs.unflatten_tiles(ib[:, 0, :], ph, pw)[:height, :width] >= 0
    tex = rs.unflatten_tiles(tapidx[:, 0, :], ph, pw)[:height, :width] >= 0
    return cov.sum(dtype=torch.int32), (cov & tex).sum(dtype=torch.int32)


def render_frame(scene: DeviceScene, view_proj, bone_mats=None, *,
                 width: int = 512, height: int = 512,
                 chunk: int = DEFAULT_CHUNK,
                 clear_color: tuple = (255, 255, 255, 255),
                 backend: str = "pallas", maxc: int | None = None,
                 mipmap: bool = False, lighting: bool = False,
                 check_overflow: bool = True, packed: bool = False,
                 tap_tiles: int | None = None):
    """Render one frame → (color, (H, W) f32 depth on the scene's device).

    ``backend="pallas"`` (the default; the reference's default is
    "scan") names the binned tile raster (the name the reference's
    production path uses): candidate chunks per tile are capped at
    ``maxc``, sized with ``auto_maxc``. The tiles-over-cap and
    tap-rows-over-cap counts go to the deferred overflow queue
    (``check_overflow``): overflow warns, or raises under
    MTR_STRICT_OVERFLOW, and is never dropped silently.
    ``backend="scan"`` is the independent oracle: every triangle against
    every pixel, ``chunk`` triangles a step (``raster_stage``,
    ``shade_stage``), no caps, no overflow; it renders any pool, bc1 and
    bc7 without ``mipmap`` too, and its color is always the (H, W, 4)
    uint8 frame.

    ``mipmap``: trilinear minification (K1's mtap epilogue, then
    ``shade_mip_tap_flat_channels``), from the tri pool in one gather
    per pixel or from the quad pool in two; otherwise the bilinear tap
    of mip 0. ``lighting``: the directional lambert term of
    ``LIGHT_DIR`` on the world normals, folded into C in K1's epilogue.
    ``tap_tiles`` (``auto_tap_tiles``) caps the compacted texture rows of
    the packed tap shade and of the trilinear shade.

    ``packed``: color is (H, W) int32 holding RGBA8 bits; otherwise it
    is the (H, W, 4) uint8 view of the same plane. As in the reference,
    the unpacked bilinear frame shades every tap row: it ignores
    ``tap_tiles`` and queues the bins count alone."""
    if backend == "scan":
        if packed:
            raise ValueError("packed output requires the pallas backend")
        return _render_frame_scan(
            scene, view_proj, bone_mats, width=width, height=height,
            chunk=chunk, clear_color=clear_color, mipmap=mipmap,
            lighting=lighting)
    if backend != "pallas":
        raise ValueError(f"unknown backend {backend!r}")
    _check_pool_path(scene, mipmap)
    dense = not packed and not mipmap
    color, depth, n_over = _render_frame_core(
        scene, view_proj, bone_mats, width=width, height=height,
        clear_color=clear_color, maxc=maxc,
        tap_tiles=None if dense else tap_tiles, mipmap=mipmap,
        lighting=lighting)
    if check_overflow:
        _queue_frame_overflow((n_over[0], None) if dense else n_over, maxc,
                              tap_tiles, width, height)
    if not packed:
        color = color.view(torch.uint8).reshape(height, width, 4)
    return color, depth


def _queue_frame_overflow(n_over, maxc, tap_tiles, width, height):
    """Queue the frame's (bins, compacted-tap rows) overflow counts (a
    tap count of None: a dense shade, bins alone). The split peel's
    (opaque, translucent) cap pair reports as its sum. ``height`` is a
    band's padded rows where the counts are a band split's."""
    n_bins, n_tap = n_over
    if n_tap is not None:
        nrows = _seg_rows_of(*_padded(width, height))
        if isinstance(tap_tiles, tuple):
            cap = sum((c if c else nrows) for c in tap_tiles)
        else:
            cap = tap_tiles if tap_tiles else nrows
        rs.queue_overflow_check(
            n_tap, cap,
            what="tap overflow: live compacted tap rows lost their "
                 "texture; raise tap_tiles")
    rs.queue_overflow_check(n_bins, maxc or rs.MAXC_DEFAULT)


# ------------------------------------------------------------ peeled frame


def _live_rows(mask) -> torch.Tensor:
    """(n_tiles, L, P) bool → device count of live SEG_PX-px rows."""
    return mask.reshape(-1, SEG_PX).any(1).sum(dtype=torch.int32)


def measure_live_tap_tiles(scene: DeviceScene, view_proj, bone_mats=None,
                           *, width: int, height: int, layers: int,
                           maxc: int | None = None, lighting: bool = False,
                           margin: float = 1.5, mode: str = "ml",
                           bands: int = 1):
    """Size ``tap_tiles`` for the peeled composite (see
    ``composite_peeled_tap_flat``), in SEG_PX-px (tile, layer) rows: run
    the frame's rasters once for this view, count the live rows on the
    device, and return count x ``margin``, rounded up to a multiple of 8
    and clamped to the grid (one device→host transfer; call it at load
    or on a scene change, like ``auto_maxc``).

    ``mode="ml"`` runs K2 with the opaque cull over every triangle and
    returns one cap. ``mode="split"`` runs K1 over the opaque set and K2
    over the translucent set behind the opaque z, and returns the
    (opaque, translucent) cap pair that ``render_frame_peeled(...,
    peel_mode="split")`` takes. ``lighting`` runs the lit setup and
    epilogues, as the lit frame does. Liveness (z and id coverage and the
    tex column) is the same for the tap and the mtap epilogues, so the
    measurement runs the tap variant and its caps serve ``mipmap=True``
    renders too, as in the reference.

    ``bands`` > 1 (``mode="split"`` only) sizes a band split
    (``parallel.tiles.render_frame_multichip(peel_layers=...)``): the
    rasters run per band at its own origin and the worst band's
    (opaque, translucent) pair comes back, in one band's rows."""
    if mode not in ("ml", "split"):
        raise ValueError(f"unknown mode {mode!r}")
    if bands > 1 and mode != "split":
        raise ValueError("bands > 1 sizing exists for mode='split' only "
                         "(the band split's peel engine)")
    pw, ph = _padded(width, height)
    nrows = _seg_rows_of(pw, ph)
    mc = maxc or rs.MAXC_DEFAULT
    light = _light_unit() if lighting else None
    kw = dict(width=pw, height=ph, w_eps=W_EPS, light=light)
    clip = vertex_stage(scene, view_proj, bone_mats)
    setup_kw = dict(bone_mats=bone_mats, lighting=lighting)

    def cap(live: int, hi: int) -> int:
        return min(max(8, -(-int(np.ceil(live * margin)) // 8) * 8), hi)

    if mode == "split":
        setup = setup_packed_cols(scene, clip, width, height,
                                  opacity_split=True, **setup_kw)
        band_h, pb = band_rows(height, bands)
        live = []
        for i in range(bands):
            (_, io, _, tio), (_, it, _, tit), front, _ = _split_rasters(
                *setup, y0=i * band_h, pw=pw, ph=pb, layers=layers,
                maxc=mc, light=light)
            live.append(torch.stack([_live_rows((io >= 0) & (tio >= 0)),
                                     _live_rows(front & (tit >= 0))]))
        live_op, live_tr = torch.stack(live).amax(0).tolist()
        nrows = _seg_rows_of(pw, pb)
        return cap(live_op, nrows), cap(live_tr, nrows * layers)

    cols, bbox = setup_packed_cols(scene, clip, width, height, **setup_kw)
    lists, glists, counts, _ = rs.prebin(cols, bbox, 0, 0, width=pw,
                                         height=ph, maxc=mc)
    _, il, _, ti = rs.raster_fwd_ml(cols, lists, glists, counts, (0, 0),
                                    layers=layers, opaque_cull=True, **kw)
    return cap(int(_live_rows((il >= 0) & (ti >= 0))), nrows * layers)


def _split_rasters(setup_op, setup_tr, *, pw: int, ph: int, layers: int,
                   maxc: int, x0: int = 0, y0: int = 0,
                   raster=rs.raster_fwd, raster_ml=rs.raster_fwd_ml,
                   mode: str = "tap", light=None):
    """The split peel's two rasters over a tile-aligned ``pw`` x ``ph``
    band whose top-left pixel is (``x0``, ``y0``) (the whole padded frame
    at the origin, or one band of ``parallel.tiles``), with the ``mode``
    epilogue ("tap" or "mtap", lit under ``light``): K1 over the opaque
    set, then K2 over the translucent set (variant "nocull") with the
    opaque z-buffer as its ``zhi`` horizon. ``setup_op``/``setup_tr`` are
    the (cols, bbox) pairs of ``setup_packed_cols(opacity_split=True)``.

    Returns (K1's outputs (z, ids, attrs[, tapidx]), K2's (zl, il,
    attrs[, tapidx]), front (n_tiles, L, P) bool: the translucent
    fragments kept and in front of the opaque winner under the exact
    (z asc, id desc) order, the device count of tiles over ``maxc`` in
    either binning)."""
    kw = dict(width=pw, height=ph, w_eps=W_EPS, mode=mode, light=light)
    (cols_op, bbox_op), (cols_tr, bbox_tr) = setup_op, setup_tr
    lists, glists, counts, nov_op = rs.prebin(cols_op, bbox_op, x0, y0,
                                              width=pw, height=ph, maxc=maxc)
    opaque = raster(cols_op, lists, glists, counts, (x0, y0), **kw)
    zo, io = opaque[:2]
    # raw opaque z where covered, +inf where not (the raster maps
    # uncovered z to 1.0, which a real z may exceed)
    zo_eff = torch.where(io >= 0, zo, float("inf"))
    lists, glists, counts, nov_tr = rs.prebin(cols_tr, bbox_tr, x0, y0,
                                              width=pw, height=ph, maxc=maxc)
    translucent = raster_ml(cols_tr, lists, glists, counts, (x0, y0),
                            layers=layers, opaque_cull=False, zhi=zo_eff,
                            **kw)
    zt, it = translucent[:2]
    front = (it >= 0) & ((zt < zo_eff) | ((zt == zo_eff) & (it > io)))
    return opaque, translucent, front, nov_op + nov_tr


def _split_peel_flat(scene: DeviceScene, setup_op, setup_tr, *, pw: int,
                     ph: int, layers: int, maxc: int, tap_tiles,
                     clear_color, x0: int = 0, y0: int = 0,
                     raster=rs.raster_fwd, raster_ml=rs.raster_fwd_ml,
                     mipmap: bool = False, light=None):
    """The split peel over a tile-aligned ``pw`` x ``ph`` band whose
    top-left pixel is (``x0``, ``y0``), as in ``_split_rasters``: the two
    rasters of ``_split_rasters``, the opaque shade and blend, then the
    translucent layers in front of the opaque winner composited over it:
    bilinear taps, or with ``mipmap`` the mtap epilogues, the trilinear
    shade and ``composite_peeled_mip_flat``; lit under ``light``.
    ``tap_tiles`` is one cap or the (opaque, translucent) pair.

    Returns (channels [r, g, b, a] each (n_tiles, P) f32 tile-major, z0
    (n_tiles, P) nearest depth with 1.0 where empty, (n_over bins,
    n_over taps))."""
    opaque, translucent, front, nov = _split_rasters(
        setup_op, setup_tr, pw=pw, ph=ph, layers=layers, maxc=maxc, x0=x0,
        y0=y0, raster=raster, raster_ml=raster_ml,
        mode="mtap" if mipmap else "tap", light=light)
    (zo, io), (zt, it) = opaque[:2], translucent[:2]
    cap_op, cap_tr = (tap_tiles if isinstance(tap_tiles, tuple)
                      else (tap_tiles, tap_tiles))
    if mipmap:
        src_op, cov_op, novt_op = shade_mip_tap_flat_channels(
            scene, opaque[2], io, tap_tiles=cap_op)
    else:
        src_op, cov_op, novt_op = shade_tap_flat_channels(
            scene, opaque[2], opaque[3], io, tap_tiles=cap_op)
    dst0 = _blend_channels(src_op, cov_op, clear_color)
    if mipmap:
        dst, novt_tr = composite_peeled_mip_flat(
            scene, translucent[2], it, layers, clear_color,
            tap_tiles=cap_tr, covered=front, dst0=dst0)
    else:
        dst, novt_tr = composite_peeled_tap_flat(
            scene, translucent[2], translucent[3], it, layers, clear_color,
            tap_tiles=cap_tr, covered=front, dst0=dst0)
    inf = float("inf")
    z0 = torch.minimum(torch.where(it[:, 0] >= 0, zt[:, 0], inf),
                       torch.where(io[:, 0] >= 0, zo[:, 0], inf))
    z0 = torch.where(torch.isfinite(z0), z0, 1.0)
    return dst, z0, (nov, novt_op + novt_tr)


def _render_frame_peeled_core(scene: DeviceScene, view_proj, bone_mats=None,
                              *, width: int, height: int, layers: int,
                              clear_color: tuple, maxc: int | None,
                              peel_mode: str, tap_tiles,
                              mipmap: bool = False, lighting: bool = False,
                              raster=rs.raster_fwd,
                              raster_ml=rs.raster_fwd_ml):
    """Peeled frame body → (packed color (H, W) i32, nearest depth
    (H, W) f32, (n_over, n_over_tap) device counts; the multipass peel's
    tap count is None: it shades densely). ``raster`` and ``raster_ml``
    are the K1 and K2 stages; passing their plain versions renders the
    same frame through them on any device."""
    pw, ph = _padded(width, height)
    mc = maxc or rs.MAXC_DEFAULT
    light = _light_unit() if lighting else None
    clip = vertex_stage(scene, view_proj, bone_mats)
    setup_kw = dict(bone_mats=bone_mats, lighting=lighting)
    if peel_mode == "multipass":
        cols, bbox = setup_packed_cols(scene, clip, width, height,
                                       **setup_kw)
        dst, z0, nov = _multipass_flat(
            scene, cols, bbox, pw=pw, ph=ph, layers=layers, maxc=mc,
            clear_color=clear_color, mipmap=mipmap, light=light,
            raster=raster)
        n_over = (nov, None)
    elif peel_mode == "split":
        setup_op, setup_tr = setup_packed_cols(scene, clip, width, height,
                                               opacity_split=True,
                                               **setup_kw)
        dst, z0, n_over = _split_peel_flat(
            scene, setup_op, setup_tr, pw=pw, ph=ph, layers=layers,
            maxc=mc, tap_tiles=tap_tiles, clear_color=clear_color,
            raster=raster, raster_ml=raster_ml, mipmap=mipmap, light=light)
    else:
        cols, bbox = setup_packed_cols(scene, clip, width, height,
                                       **setup_kw)
        lists, glists, counts, nov = rs.prebin(cols, bbox, 0, 0, width=pw,
                                               height=ph, maxc=mc)
        out = raster_ml(cols, lists, glists, counts, (0, 0), width=pw,
                        height=ph, layers=layers, w_eps=W_EPS,
                        opaque_cull=True, mode="mtap" if mipmap else "tap",
                        light=light)
        if mipmap:
            dst, novt = composite_peeled_mip_flat(
                scene, out[2], out[1], layers, clear_color,
                tap_tiles=tap_tiles)
        else:
            dst, novt = composite_peeled_tap_flat(
                scene, out[2], out[3], out[1], layers, clear_color,
                tap_tiles=tap_tiles)
        z0 = out[0][:, 0, :]
        n_over = (nov, novt)
    color = rs.unflatten_tiles(pack_u32_channels(dst), ph, pw)
    depth = rs.unflatten_tiles(z0, ph, pw)
    return (color[:height, :width].contiguous(),
            depth[:height, :width].contiguous(), n_over)


def render_frame_peeled(scene: DeviceScene, view_proj, bone_mats=None, *,
                        width: int = 512, height: int = 512,
                        layers: int = 4, chunk: int = DEFAULT_CHUNK,
                        clear_color: tuple = (255, 255, 255, 255),
                        backend: str = "pallas", maxc: int | None = None,
                        mipmap: bool = False, lighting: bool = False,
                        check_overflow: bool = True, peel_mode: str = "ml",
                        packed: bool = False, tap_tiles=None):
    """Order-independent transparency → (color, (H, W) f32 nearest depth
    on the scene's device).

    ``peel_mode="ml"`` rasters every triangle in one pass of K2, which
    keeps the ``layers`` (2..8) nearest fragments per pixel under
    (z asc, id desc) with the opaque cull, and composites them back to
    front. ``"split"``, the production mode, rasters the opaque
    triangles through K1 and only the translucent ones through K2, and
    keeps the translucent fragments in front of the opaque winner: the
    opaque surface plus the L nearest translucent fragments in front of
    it. It equals "ml" wherever fewer than ``layers`` translucent
    fragments cover a pixel. ``tap_tiles`` compacts the texture taps
    (size it with ``measure_live_tap_tiles``; for "split" it may be the
    (opaque, translucent) pair); None = dense. Bin and tap overflow go
    to the deferred queue (``check_overflow``), as in ``render_frame``.

    ``mipmap`` and ``lighting`` as in ``render_frame``: every layer runs
    the mtap epilogue and the trilinear shade (``composite_peeled_mip_
    flat``), and C is lit in the rasters' epilogues.

    ``"multipass"`` (any ``layers`` >= 1) peels with K1 once per layer:
    bin once, then each pass excludes depths at or in front of the
    previous layer + PEEL_EPS (``zlow``), so surfaces closer than that
    collapse into one layer; it equals "ml" on scenes whose surfaces
    are separated by more. Each pass shades densely: the tap epilogue,
    or mipmapped the attrs epilogue and ``shade_fwd`` (lighting there,
    from the normal planes); the layers blend back to front. It ignores
    an int ``tap_tiles`` and returns the (H, W, 4) uint8 frame.

    ``backend="scan"`` (``peel_mode`` "ml" or "multipass", any
    ``layers`` >= 1): ``raster_multilayer``'s L nearest fragments, each
    shaded by ``shade_src``, blended back to front; the uint8 frame.

    ``packed``: color is (H, W) int32 holding RGBA8 bits; otherwise it
    is the (H, W, 4) uint8 view of the same plane. Only the pallas
    backend's single-pass peels ("ml", "split") pack."""
    if peel_mode not in ("ml", "multipass", "split"):
        raise ValueError(f"unknown peel_mode {peel_mode!r}")
    if backend not in ("pallas", "scan"):
        raise ValueError(f"unknown backend {backend!r}")
    if peel_mode == "split" and (backend != "pallas" or layers < 2):
        raise ValueError("peel_mode='split' requires the pallas backend "
                         "and layers >= 2")
    if packed and (backend != "pallas" or peel_mode == "multipass"):
        raise ValueError("packed peeled output requires the pallas "
                         "backend's single-pass (ml/split) path")
    if backend == "scan" or peel_mode == "multipass":
        if layers < 1:
            raise ValueError(f"layers={layers}: the peel needs >= 1")
    elif not 2 <= layers <= rs.MAX_LAYERS:
        raise ValueError(f"layers={layers} out of range "
                         f"[2, {rs.MAX_LAYERS}]")
    if isinstance(tap_tiles, tuple) and peel_mode != "split":
        raise ValueError("tuple tap_tiles is the split peel's "
                         "(opaque, translucent) cap pair")
    if backend == "scan":
        return _render_frame_scan(
            scene, view_proj, bone_mats, width=width, height=height,
            chunk=chunk, clear_color=clear_color, mipmap=mipmap,
            lighting=lighting, layers=layers)
    _check_pool_path(scene, mipmap)
    color, depth, n_over = _render_frame_peeled_core(
        scene, view_proj, bone_mats, width=width, height=height,
        layers=layers, clear_color=clear_color, maxc=maxc,
        peel_mode=peel_mode, tap_tiles=tap_tiles, mipmap=mipmap,
        lighting=lighting)
    if check_overflow:
        _queue_frame_overflow(n_over, maxc, tap_tiles, width, height)
    if not packed:
        color = color.view(torch.uint8).reshape(height, width, 4)
    return color, depth
