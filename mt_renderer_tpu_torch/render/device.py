"""Device stages of a frame — vertex, setup, binning, raster, shade, pack.

The counterpart of ``mt_renderer_tpu/render/device.py`` on the packed
single-layer paths (``render_frame(backend="pallas", packed=True)``)
and the peeled (order-independent transparency) paths
(``render_frame_peeled``, ``peel_mode="split"`` and ``"ml"``), each
bilinear tap or, with ``mipmap``, trilinear; lit or unlit. The
single-layer frame runs:

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
trilinearly).

Pixel rules (coverage at centers with the top-left rule and edge-snap
band folded into a per-edge bias, back-face cull of area2 >= 0, the
``0 <= z`` test, LessEqual depth with later-global-id tie wins) match
``render.cpu_reference`` (this package's copy of the JAX package's NumPy
oracle).

Tensors live on the scene's device; every function takes its device from
its inputs. The host sizing helpers (``auto_maxc``, ``auto_tap_tiles``)
run in NumPy on the host ``DrawBatch`` and never touch the device.

The packed frame is an int32 tensor holding the RGBA8 bits (PyTorch has
few uint32 ops); ``unpack_rgba`` views it as (H, W, 4) uint8 on the
host. ``bilin_swar`` (kernel K4, ``csrc/bilin_swar.cu``) is the integer
SWAR form of the bilinear contraction that
``mt_renderer_tpu_torch.tools.bilin_ab`` prices against the f32 one.
"""

from __future__ import annotations

import ctypes
import logging
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..scene.model import DEBUG_PALETTE, DrawBatch
from . import cpu_reference as cr
from . import raster as rs

logger = logging.getLogger("mt_renderer_tpu_torch.device")

W_EPS = 1e-6
SEG_PX = 2048          # tap-compaction row: one whole flattened tile
TRI_PAD = 384          # triangle-count padding quantum: one raster chunk

_WHY_SCAN = ("the port keeps only the binned tile raster; scan stays a "
             "reference harness")

# modes and options of the reference that later PRs port
_SLICE_POOL_REST = "slice 3, the rest of upload (ROADMAP Queue 1 item 10a)"
_SLICE_POOL = {
    "narrow": _SLICE_POOL_REST,
    "auto": _SLICE_POOL_REST,
    "bc1": "slice 4 (ROADMAP Queue 1 item 12)",
    "bc7": "slice 4 (ROADMAP Queue 1 item 13)",
}
POOL_ROW_BYTES = {"quad": 16, "tri": 128}   # ported pools' physical rows


def _not_ported(what: str, where: str):
    return NotImplementedError(f"{what} is not ported yet: {where}")


def _by_decision(what: str, why: str):
    return NotImplementedError(
        f"{what} is not ported, by decision: {why} (ROADMAP Queue 1, "
        "'Not ported, by decision')")


TENSOR_FIELDS = (
    "positions", "uvs", "normals", "joints", "weights",
    "tri_texture", "tri_debug_id", "tri_flat", "tri_material", "mat_color",
    "tri_valid", "tri_parts", "parts_mask", "tex_size",
    "mip_pool", "mip_table", "cols_const", "tri_vis",
)
STATIC_FIELDS = ("num_joints", "skinned", "num_mips", "pool_mode")


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
    # all mips; "quad": (R, 16) u8, a texel's 2x2 quad per row; "tri":
    # (ceil(R/2), 128) u8, two 64 B logical rows per physical row, each
    # the quad plus the 3x3 level-(m+1) parent block (_build_tri_pool)
    mip_pool: torch.Tensor
    mip_table: torch.Tensor     # (L, M, 3) i32 — (offset, h, w) per mip
    # per-triangle constants, column-major (10, Tp): [tex, cbase rgba
    # (1 for textured, flat/debug color otherwise), off_hi, off_lo, th,
    # tw, texture fully opaque]
    cols_const: torch.Tensor    # (10, Tp) f32
    tri_vis: torch.Tensor       # (Tp,) bool — tri_valid & parts_mask[tri_parts]
    num_joints: int
    skinned: bool
    num_mips: int = 1
    pool_mode: str = "quad"

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


def _build_tri_pool(qpool, segs_h: np.ndarray):
    """(R, 16) u8 quad pool → (ceil(R/2), 128) u8 tri pool, built on the
    quad pool's device: logical 64 B rows (quad + 3x3 parent block), two
    per physical row, as the reference packs them (an odd R repeats the
    last logical row). ``_pool_rows`` reads logical row i as 64 B row i
    of the same bytes, so a trilinear tap is one 64 B gather."""
    rows = qpool.shape[0]
    if segs_h.size == 0:
        segs_h = np.array([[0, 1, 1, -1, 1, 1]], np.int32)
    segs = torch.as_tensor(np.asarray(segs_h, np.int32), device=qpool.device)
    half = (rows + 1) // 2
    chunk = min(_TRI_BUILD_CHUNK // 2, max(1 << 11, half), half)
    out = torch.empty((half, 128), dtype=torch.uint8, device=qpool.device)
    for start in range(0, half, chunk):
        s = min(start, half - chunk)
        out[s:s + chunk] = _tri_chunk_rows(qpool, segs, 2 * s,
                                           2 * chunk).reshape(chunk, 128)
    return out


def upload(batch: DrawBatch, pool_mode: str = "quad", *, device,
           pool_bias: int = 0) -> DeviceScene:
    """Pad a host DrawBatch to whole chunks and copy it to ``device``.
    Called once at load time.

    ``pool_mode="quad"``: each pool row holds a texel's full 2x2
    bilinear footprint, mip chains included (16 B per texel; one gather
    per bilinear tap, two per trilinear tap). ``"tri"``: 64 B per texel,
    the quad plus the 3x3 parent-level block every trilinear footprint
    needs, so a trilinear tap is one gather (built on the device from
    the quad rows, ``_build_tri_pool``); bilinear taps read its quad
    bytes. ``pool_bias`` (the LOD clamp), "narrow" and "auto" are not
    ported yet."""
    if pool_bias:
        raise _not_ported("pool_bias", _SLICE_POOL_REST)
    if pool_mode in _SLICE_POOL:
        raise _not_ported(f"pool_mode={pool_mode!r}", _SLICE_POOL[pool_mode])
    if pool_mode not in POOL_ROW_BYTES:
        raise ValueError(f"unknown pool_mode {pool_mode!r}")
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
    src_texs = batch.textures or [np.zeros((4, 4, 4), np.uint8)]
    tables = [mip_chain(img) for img in src_texs]
    n_mips = max(len(c) for c in tables)
    if batch.textures:
        sizes = np.array([(x.shape[0], x.shape[1]) for x in batch.textures],
                         np.int32)
    else:
        sizes = np.array([[4, 4]], np.int32)
    table = np.zeros((len(src_texs), n_mips, 3), np.int32)
    pool_parts = []
    segs = []     # (off, h, w, parent off | -1, ph, pw) per stored level
    offset = 0
    for li, chain in enumerate(tables):
        for mi in range(n_mips):
            if mi < len(chain):
                img = chain[mi]
                h, w = img.shape[:2]
                table[li, mi] = (offset, h, w)
                pool_parts.append(quad_rows(img))
                if mi + 1 < len(chain):
                    nxt = chain[mi + 1]
                    segs.append((offset, h, w, offset + h * w,
                                 nxt.shape[0], nxt.shape[1]))
                else:
                    segs.append((offset, h, w, -1, 1, 1))
                offset += h * w
            else:
                table[li, mi] = table[li, len(chain) - 1]
    mip_pool = np.concatenate(pool_parts)
    logger.info("texel pool (%s): %d rows, %.2f MiB", pool_mode,
                mip_pool.shape[0],
                mip_pool.shape[0] * (64 if pool_mode == "tri" else 16)
                / 2**20)
    if pool_mode == "tri":
        mip_pool = _build_tri_pool(torch.from_numpy(mip_pool).to(device),
                                   np.asarray(segs, np.int32))

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
    )
    statics = dict(num_joints=nj, skinned=bool(batch.skinned),
                   num_mips=n_mips, pool_mode=pool_mode)
    return scene_from_numpy(leaves, statics, device)


def scene_from_numpy(leaves: dict, statics: dict, device) -> DeviceScene:
    """Build a scene from host arrays: ``leaves`` maps every name in
    ``TENSOR_FIELDS`` to a NumPy array (or a tensor), ``statics`` every
    name in ``STATIC_FIELDS`` to its value. The arrays of another
    package's uploaded scene, converted to NumPy, carry its state across,
    the quad or tri texel pool included."""
    pool_mode = statics["pool_mode"]
    if pool_mode in _SLICE_POOL:
        raise _not_ported(f"pool_mode={pool_mode!r}", _SLICE_POOL[pool_mode])
    if pool_mode not in POOL_ROW_BYTES:
        raise ValueError(f"unknown pool_mode {pool_mode!r}")
    tensors = {f: (leaves[f].to(device) if isinstance(leaves[f], torch.Tensor)
                   else torch.tensor(np.asarray(leaves[f]), device=device))
               for f in TENSOR_FIELDS}
    pool = tensors["mip_pool"]
    if pool.dtype != torch.uint8 or pool.shape[-1] != POOL_ROW_BYTES[
            pool_mode]:
        raise ValueError(f"a {pool_mode} pool has u8 rows of "
                         f"{POOL_ROW_BYTES[pool_mode]} B, got {pool.dtype} "
                         f"{tuple(pool.shape)}")
    return DeviceScene(**tensors, **{k: statics[k] for k in STATIC_FIELDS})


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
    cc = clip.reshape(3, tp, 4)                           # corner-planar
    w = [cc[i, :, 3] for i in range(3)]
    inv_w = [torch.reciprocal(torch.where(wi.abs() < W_EPS, W_EPS, wi))
             for wi in w]
    sx = [(cc[i, :, 0] * inv_w[i] + 1.0) * (0.5 * width) for i in range(3)]
    sy = [(1.0 - cc[i, :, 1] * inv_w[i]) * (0.5 * height) for i in range(3)]
    sz = [cc[i, :, 2] * inv_w[i] for i in range(3)]

    area2 = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (
        sx[2] - sx[0])
    valid = (scene.tri_vis & (w[0] > W_EPS) & (w[1] > W_EPS)
             & (w[2] > W_EPS) & (area2 < 0.0))
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

    big = 1e30
    cg = tp // rs.KG

    def cmin(vals, v):
        m = torch.minimum(torch.minimum(vals[0], vals[1]), vals[2])
        return torch.where(v, m, big).reshape(cg, rs.KG).amin(1)

    def cmax(vals, v):
        m = torch.maximum(torch.maximum(vals[0], vals[1]), vals[2])
        return torch.where(v, m, -big).reshape(cg, rs.KG).amax(1)

    def finish(bias0, v):
        cols = torch.stack(ea + eb + ec + [bias0] + bias[1:] + tail, 0)
        return cols, (cmin(sx, v), cmax(sx, v), cmin(sy, v), cmax(sy, v),
                      cmin(sz, v))                    # (33 or 42, Tp), bbox

    if opacity_split:
        return (finish(torch.where(opq, bias[0], rs.REJECT), valid & opq),
                finish(torch.where(opq, rs.REJECT, bias[0]), valid & ~opq))
    return finish(bias[0], valid)


def _mat_select(mat_color, tri_material) -> torch.Tensor:
    """Per-triangle material color → (4, Tp) f32."""
    return mat_color[tri_material.long()].T


# ------------------------------------------------------------ tap shade


def _pool_rows(pool, idx, nbytes: int):
    """The first ``nbytes`` (16: the quad; 64: quad + parent block) of
    logical pool rows ``idx`` (clamped below at 0), one gather. A tri
    pool's physical 128 B row i holds logical rows 2i and 2i+1, so its
    logical row i is 64 B row i of the same bytes and its quad is 16 B
    row 4i."""
    idx = idx.clamp(min=0).long()
    if pool.shape[-1] == 16 and nbytes == 16:
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
    a tri pool)."""
    return _contract_quad(_pool_rows(pool, idx, 16), fx, fy)


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
        a = src[3] / 255.0
        cov = covered[:, layer]
        dst = ([torch.where(cov, src[c] * a + dst[c] * (1.0 - a), dst[c])
                for c in range(3)]
               + [torch.where(cov, src[3], dst[3])])
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
    (hm, wm): one 16 B gather + the contraction."""
    x0c, y0c, fx, fy = _tap_address(u, v, hm, wm)
    return _contract_quad(_pool_rows(pool, off + y0c * wm + x0c, 16), fx, fy)


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


def _trilinear_arith(pool, off0, th, tw, lod, u, v, num_mips: int) -> list:
    """Trilinear sample with arithmetic mip addressing (``_mip_arith``)
    → 4 channel tensors: lod clipped to [0, num_mips - 1], both levels
    clamped to the texture's last real level. A tri pool takes both
    levels from one gather (``_trilinear_fused``), a quad pool from two
    ``_quad_bilinear`` taps."""
    big = torch.maximum(th, tw)
    mmax = torch.zeros_like(th)
    for m in range(1, num_mips):
        mmax = torch.where((big >> m) > 0, m, mmax)
    lod = lod.clamp(0.0, float(num_mips - 1))
    m0f = torch.floor(lod)
    fm = lod - m0f
    m0 = torch.minimum(rs._trunc_i32(m0f), mmax)
    m1 = torch.minimum(m0 + 1, mmax)
    off_a, hm0, wm0 = _mip_arith(off0, th, tw, m0, num_mips)
    hm1 = (th >> m1).clamp(min=1)
    wm1 = (tw >> m1).clamp(min=1)
    if pool.shape[-1] == 128:
        s0, s1 = _trilinear_fused(pool, off_a, hm0, wm0, hm1, wm1, m0, m1,
                                  u, v)
    else:
        off_b = off_a + torch.where(m1 > m0, hm0 * wm0, 0)
        s0 = _quad_bilinear(pool, off_a, hm0, wm0, u, v)
        s1 = _quad_bilinear(pool, off_b, hm1, wm1, u, v)
    return [a * (1 - fm) + b * fm for a, b in zip(s0, s1)]


def _mip_albedo_channels(scene: DeviceScene, m) -> list:
    """Trilinear albedo from mtap planes ``m`` (..., 17, X) → 4 channel
    tensors (..., X): analytic LOD, arithmetic mip addressing; elementwise
    per pixel, so it runs on compacted rows as on dense ones."""
    u = m[..., 0, :]
    v = m[..., 1, :]
    off0 = rs._trunc_i32(m[..., 3, :]) * 4096 + rs._trunc_i32(m[..., 4, :])
    th = rs._trunc_i32(m[..., 5, :])
    tw = rs._trunc_i32(m[..., 6, :])
    lod = _analytic_lod(u, v, *[m[..., 11 + i, :] for i in range(6)],
                        m[..., 5, :], m[..., 6, :])
    return _trilinear_arith(scene.mip_pool, off0, th, tw, lod, u, v,
                            scene.num_mips)


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
        a = src[3] / 255.0
        cov = covered[:, layer]
        dst = ([torch.where(cov, src[c] * a + dst[c] * (1.0 - a), dst[c])
                for c in range(3)]
               + [torch.where(cov, src[3], dst[3])])
    return dst, n_over_tap


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
    c = clip[batch.tris]                                  # (T, 3, 4)
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
                       width: int, height: int) -> np.ndarray:
    """NumPy mirror of ``raster.bin_chunks``: per-tile candidate-chunk
    counts (n_ty, n_tx) for this view, computed from the host batch with
    no device work."""
    pw, ph = _padded(width, height)
    xmin, xmax, ymin, ymax, _ = _chunk_bboxes(
        batch, view_proj, bone_mats, width=width, height=height)
    n_ty, n_tx = ph // rs.TILE_H, pw // rs.TILE_W
    ty0 = np.arange(n_ty, dtype=np.float32) * rs.TILE_H
    tx0 = np.arange(n_tx, dtype=np.float32) * rs.TILE_W
    ovy = (ymax[:, None] >= ty0) & (ymin[:, None] <= ty0 + rs.TILE_H)
    ovx = (xmax[:, None] >= tx0) & (xmin[:, None] <= tx0 + rs.TILE_W)
    return (ovy[:, :, None] & ovx[:, None, :]).sum(axis=0)


def predict_live_rows(batch, view_proj, bone_mats=None, *,
                      width: int, height: int) -> int:
    """Host upper bound on live SEG_PX-px tap rows for this view: a row
    can only be textured and covered if a textured chunk's bbox
    overlaps it."""
    pw, ph = _padded(width, height)
    xmin, xmax, ymin, ymax, tex = _chunk_bboxes(
        batch, view_proj, bone_mats, width=width, height=height)
    xmin, xmax = xmin[tex], xmax[tex]
    ymin, ymax = ymin[tex], ymax[tex]
    seg_h = SEG_PX // rs.TILE_W     # pixel rows per compaction segment
    n_tx = pw // rs.TILE_W
    tx0 = np.arange(n_tx, dtype=np.float32) * rs.TILE_W
    ys = np.arange(ph // seg_h, dtype=np.float32) * seg_h
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


def auto_tap_tiles(batch, view_proj, bone_mats=None, *,
                   width: int, height: int, margin: float = 1.25) -> int:
    """Host-side cap for the compacted texture tap, in SEG_PX-px rows:
    ``predict_live_rows`` x ``margin``, rounded up to a multiple of 8
    and clamped to the grid's row count."""
    pw, ph = _padded(width, height)
    nrows = (pw // rs.TILE_W) * (ph // (SEG_PX // rs.TILE_W))
    live = predict_live_rows(batch, view_proj, bone_mats,
                             width=width, height=height)
    return min(max(8, -(-int(np.ceil(live * margin)) // 8) * 8), nrows)


# ------------------------------------------------------------------ frame


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
    clip = vertex_stage(scene, view_proj, bone_mats)
    cols, bbox = setup_packed_cols(scene, clip, width, height,
                                   bone_mats=bone_mats, lighting=lighting)
    lists, glists, counts, n_over = rs.prebin(
        cols, bbox, 0, 0, width=pw, height=ph,
        maxc=maxc or rs.MAXC_DEFAULT)
    kw = dict(width=pw, height=ph, w_eps=W_EPS,
              light=_light_unit() if lighting else None)
    if mipmap:
        zb, ib, mattrs = raster(cols, lists, glists, counts, (0, 0),
                                mode="mtap", **kw)
        src, covered, n_over_tap = shade_mip_tap_flat_channels(
            scene, mattrs, ib, tap_tiles=tap_tiles)
        colort = _blend_pack_u32(src, covered, clear_color)
    else:
        zb, ib, tattrs, tapidx = raster(cols, lists, glists, counts, (0, 0),
                                        **kw)
        colort, _, n_over_tap = shade_finish_tap_flat(
            scene, tattrs, tapidx, ib, clear_color, tap_tiles=tap_tiles)
    color = rs.unflatten_tiles(colort, ph, pw)[:height, :width]
    depth = rs.unflatten_tiles(zb[:, 0, :], ph, pw)[:height, :width]
    return color.contiguous(), depth.contiguous(), (n_over, n_over_tap)


def render_frame(scene: DeviceScene, view_proj, bone_mats=None, *,
                 width: int = 512, height: int = 512,
                 clear_color: tuple = (255, 255, 255, 255),
                 backend: str = "pallas", maxc: int | None = None,
                 mipmap: bool = False, lighting: bool = False,
                 check_overflow: bool = True, packed: bool = False,
                 tap_tiles: int | None = None):
    """Render one frame → (color, (H, W) f32 depth on the scene's device).

    ``backend="pallas"`` names the binned tile raster (the name the
    reference's production path uses): candidate chunks per tile are
    capped at ``maxc``, sized with ``auto_maxc``. The tiles-over-cap
    and tap-rows-over-cap counts go to the deferred overflow queue
    (``check_overflow``): overflow warns, or raises under
    MTR_STRICT_OVERFLOW, and is never dropped silently.

    ``mipmap``: trilinear minification (K1's mtap epilogue, then
    ``shade_mip_tap_flat_channels``), from the tri pool in one gather
    per pixel or from the quad pool in two; otherwise the bilinear tap
    of mip 0. ``lighting``: the directional lambert term of
    ``LIGHT_DIR`` on the world normals, folded into C in K1's epilogue.
    ``tap_tiles`` (``auto_tap_tiles``) caps the compacted texture rows of
    either shade.

    ``packed``: color is (H, W) int32 holding RGBA8 bits; otherwise it
    is the (H, W, 4) uint8 view of the same plane."""
    if backend != "pallas":
        raise _by_decision(f"backend={backend!r}", _WHY_SCAN)
    color, depth, n_over = _render_frame_core(
        scene, view_proj, bone_mats, width=width, height=height,
        clear_color=clear_color, maxc=maxc, tap_tiles=tap_tiles,
        mipmap=mipmap, lighting=lighting)
    if check_overflow:
        _queue_frame_overflow(n_over, maxc, tap_tiles, width, height)
    if not packed:
        color = color.view(torch.uint8).reshape(height, width, 4)
    return color, depth


def _queue_frame_overflow(n_over, maxc, tap_tiles, width, height):
    """Queue the frame's (bins, compacted-tap rows) overflow counts. The
    split peel's (opaque, translucent) cap pair reports as its sum."""
    n_bins, n_tap = n_over
    pw, ph = _padded(width, height)
    nrows = (pw // rs.TILE_W) * (ph // (SEG_PX // rs.TILE_W))
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
    renders too, as in the reference."""
    if bands > 1:
        raise _not_ported("measure_live_tap_tiles(bands > 1)",
                          "slice 6 (ROADMAP Queue 1 item 18)")
    if mode not in ("ml", "split"):
        raise ValueError(f"unknown mode {mode!r}")
    pw, ph = _padded(width, height)
    nrows = (pw // rs.TILE_W) * (ph // (SEG_PX // rs.TILE_W))
    mc = maxc or rs.MAXC_DEFAULT
    light = _light_unit() if lighting else None
    kw = dict(width=pw, height=ph, w_eps=W_EPS, light=light)
    clip = vertex_stage(scene, view_proj, bone_mats)
    setup_kw = dict(bone_mats=bone_mats, lighting=lighting)

    def cap(live: int, hi: int) -> int:
        return min(max(8, -(-int(np.ceil(live * margin)) // 8) * 8), hi)

    if mode == "split":
        (_, io, _, tio), (_, it, _, tit), front, _ = _split_rasters(
            *setup_packed_cols(scene, clip, width, height,
                               opacity_split=True, **setup_kw),
            pw=pw, ph=ph, layers=layers, maxc=mc, light=light)
        live_op, live_tr = torch.stack(
            [_live_rows((io >= 0) & (tio >= 0)),
             _live_rows(front & (tit >= 0))]).tolist()
        return cap(live_op, nrows), cap(live_tr, nrows * layers)

    cols, bbox = setup_packed_cols(scene, clip, width, height, **setup_kw)
    lists, glists, counts, _ = rs.prebin(cols, bbox, 0, 0, width=pw,
                                         height=ph, maxc=mc)
    _, il, _, ti = rs.raster_fwd_ml(cols, lists, glists, counts, (0, 0),
                                    layers=layers, opaque_cull=True, **kw)
    return cap(int(_live_rows((il >= 0) & (ti >= 0))), nrows * layers)


def _split_rasters(setup_op, setup_tr, *, pw: int, ph: int, layers: int,
                   maxc: int, raster=rs.raster_fwd,
                   raster_ml=rs.raster_fwd_ml, mode: str = "tap",
                   light=None):
    """The split peel's two rasters over the padded ``pw`` x ``ph``
    frame, with the ``mode`` epilogue ("tap" or "mtap", lit under
    ``light``): K1 over the opaque set, then K2 over the translucent set
    (variant "nocull") with the opaque z-buffer as its ``zhi`` horizon.
    ``setup_op``/``setup_tr`` are the (cols, bbox) pairs of
    ``setup_packed_cols(opacity_split=True)``.

    Returns (K1's outputs (z, ids, attrs[, tapidx]), K2's (zl, il,
    attrs[, tapidx]), front (n_tiles, L, P) bool: the translucent
    fragments kept and in front of the opaque winner under the exact
    (z asc, id desc) order, the device count of tiles over ``maxc`` in
    either binning)."""
    kw = dict(width=pw, height=ph, w_eps=W_EPS, mode=mode, light=light)
    (cols_op, bbox_op), (cols_tr, bbox_tr) = setup_op, setup_tr
    lists, glists, counts, nov_op = rs.prebin(cols_op, bbox_op, 0, 0,
                                              width=pw, height=ph, maxc=maxc)
    opaque = raster(cols_op, lists, glists, counts, (0, 0), **kw)
    zo, io = opaque[:2]
    # raw opaque z where covered, +inf where not (the raster maps
    # uncovered z to 1.0, which a real z may exceed)
    zo_eff = torch.where(io >= 0, zo, float("inf"))
    lists, glists, counts, nov_tr = rs.prebin(cols_tr, bbox_tr, 0, 0,
                                              width=pw, height=ph, maxc=maxc)
    translucent = raster_ml(cols_tr, lists, glists, counts, (0, 0),
                            layers=layers, opaque_cull=False, zhi=zo_eff,
                            **kw)
    zt, it = translucent[:2]
    front = (it >= 0) & ((zt < zo_eff) | ((zt == zo_eff) & (it > io)))
    return opaque, translucent, front, nov_op + nov_tr


def _split_peel_flat(scene: DeviceScene, setup_op, setup_tr, *, pw: int,
                     ph: int, layers: int, maxc: int, tap_tiles,
                     clear_color, raster=rs.raster_fwd,
                     raster_ml=rs.raster_fwd_ml, mipmap: bool = False,
                     light=None):
    """The split peel over the padded ``pw`` x ``ph`` frame: the two
    rasters of ``_split_rasters``, the opaque shade and blend, then the
    translucent layers in front of the opaque winner composited over it:
    bilinear taps, or with ``mipmap`` the mtap epilogues, the trilinear
    shade and ``composite_peeled_mip_flat``; lit under ``light``.
    ``tap_tiles`` is one cap or the (opaque, translucent) pair.

    Returns (channels [r, g, b, a] each (n_tiles, P) f32 tile-major, z0
    (n_tiles, P) nearest depth with 1.0 where empty, (n_over bins,
    n_over taps))."""
    opaque, translucent, front, nov = _split_rasters(
        setup_op, setup_tr, pw=pw, ph=ph, layers=layers, maxc=maxc,
        raster=raster, raster_ml=raster_ml,
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
    (H, W) f32, (n_over, n_over_tap) device counts). ``raster`` and
    ``raster_ml`` are the K1 and K2 stages; passing their plain versions
    renders the same frame through them on any device."""
    pw, ph = _padded(width, height)
    mc = maxc or rs.MAXC_DEFAULT
    light = _light_unit() if lighting else None
    clip = vertex_stage(scene, view_proj, bone_mats)
    setup_kw = dict(bone_mats=bone_mats, lighting=lighting)
    if peel_mode == "split":
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
                        layers: int = 4,
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

    ``packed``: color is (H, W) int32 holding RGBA8 bits; otherwise it
    is the (H, W, 4) uint8 view of the same plane."""
    if peel_mode not in ("ml", "multipass", "split"):
        raise ValueError(f"unknown peel_mode {peel_mode!r}")
    if peel_mode == "multipass":
        raise _by_decision(
            "peel_mode='multipass'", "it re-rasters the frame once per "
            "layer and stays the reference's differential oracle for 'ml'")
    if backend != "pallas":
        raise _by_decision(f"backend={backend!r}", _WHY_SCAN)
    if peel_mode == "split" and layers < 2:
        raise ValueError("peel_mode='split' requires layers >= 2")
    if not 2 <= layers <= rs.MAX_LAYERS:
        raise ValueError(f"layers={layers} out of range "
                         f"[2, {rs.MAX_LAYERS}]")
    if isinstance(tap_tiles, tuple) and peel_mode != "split":
        raise ValueError("tuple tap_tiles is the split peel's "
                         "(opaque, translucent) cap pair")
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
