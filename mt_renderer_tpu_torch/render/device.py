"""Device stages of a frame — vertex, setup, binning, raster, tap shade, pack.

The counterpart of ``mt_renderer_tpu/render/device.py`` on the packed
single-layer tap path (``render_frame(backend="pallas", packed=True)``)
and the peeled (order-independent transparency) tap path
(``render_frame_peeled``, ``peel_mode="split"`` and ``"ml"``). The
single-layer frame runs:

1. ``vertex_stage`` — bone-palette skinning (a gather and a weighted
   sum) + MVP, written as elementwise fp32 ops;
2. ``setup_packed_cols`` — edge coefficients, top-left/snap bias
   (``REJECT`` for invalid triangles), the z, u/w, v/w and 1/w planes,
   the opacity code in the tex column, C rgba and the mip-0 constants,
   as one column-major ``(33, Tp)`` matrix, plus 32-triangle group
   bboxes;
3. ``raster.prebin`` — per-tile chunk lists and group masks;
4. ``raster.raster_fwd`` — the K1 kernel with its tap epilogue;
5. ``shade_finish_tap_flat`` — the compacted quad-pool gather, bilinear
   filter, color modulate, src-alpha blend and RGBA pack;
6. ``raster.unflatten_tiles`` + the deferred overflow queue.

The split peel partitions the setup by opacity
(``setup_packed_cols(opacity_split=True)``), rasters the opaque set
through K1 and the translucent set through the multi-layer kernel K2
(``raster.raster_fwd_ml``) behind the opaque z, shades the opaque pass
and composites the translucent layers in front of it
(``composite_peeled_tap_flat``).

Pixel rules (coverage at centers with the top-left rule and edge-snap
band folded into a per-edge bias, back-face cull of area2 >= 0, the
``0 <= z`` test, LessEqual depth with later-global-id tie wins) match
``mt_renderer_tpu.render.cpu_reference``.

Tensors live on the scene's device; every function takes its device from
its inputs. The host sizing helpers (``auto_maxc``, ``auto_tap_tiles``)
run in NumPy on the host ``DrawBatch`` and never touch the device.

The packed frame is an int32 tensor holding the RGBA8 bits (PyTorch has
few uint32 ops); ``unpack_rgba`` views it as (H, W, 4) uint8 on the
host.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from mt_renderer_tpu.render import cpu_reference as cr
from mt_renderer_tpu.scene.model import DEBUG_PALETTE, DrawBatch

from . import raster as rs

logger = logging.getLogger("mt_renderer_tpu_torch.device")

W_EPS = 1e-6
SEG_PX = 2048          # tap-compaction row: one whole flattened tile
TRI_PAD = 384          # triangle-count padding quantum: one raster chunk

_WHY_SCAN = ("the port keeps only the binned tile raster; scan stays a "
             "reference harness")

# modes and options of the reference that later slices port
_SLICE_MIP = "slice 3 (ROADMAP Queue 1 item 8)"
_SLICE_LIGHT = "slice 3 (ROADMAP Queue 1 item 9)"
_SLICE_POOL = {
    "narrow": _SLICE_MIP,
    "tri": _SLICE_MIP,
    "auto": _SLICE_MIP,
    "bc1": "slice 4 (ROADMAP Queue 1 item 12)",
    "bc7": "slice 4 (ROADMAP Queue 1 item 13)",
}


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
    mip_pool: torch.Tensor      # (R, 16) u8 — all mips; 2x2 quad per row
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


def upload(batch: DrawBatch, pool_mode: str = "quad", *,
           device) -> DeviceScene:
    """Pad a host DrawBatch to whole chunks and copy it to ``device``.
    Called once at load time. Only the quad texel pool is ported: each
    pool row holds a texel's full 2x2 bilinear footprint, mip chains
    included (16 B per texel)."""
    if pool_mode in _SLICE_POOL:
        raise _not_ported(f"pool_mode={pool_mode!r}", _SLICE_POOL[pool_mode])
    if pool_mode != "quad":
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
    offset = 0
    for li, chain in enumerate(tables):
        for mi in range(n_mips):
            if mi < len(chain):
                img = chain[mi]
                table[li, mi] = (offset, img.shape[0], img.shape[1])
                pool_parts.append(quad_rows(img))
                offset += img.shape[0] * img.shape[1]
            else:
                table[li, mi] = table[li, len(chain) - 1]
    mip_pool = np.concatenate(pool_parts)
    logger.info("texel pool (quad): %d rows, %.2f MiB", mip_pool.shape[0],
                mip_pool.nbytes / 2**20)

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
                   num_mips=n_mips, pool_mode="quad")
    return scene_from_numpy(leaves, statics, device)


def scene_from_numpy(leaves: dict, statics: dict, device) -> DeviceScene:
    """Build a scene from host arrays: ``leaves`` maps every name in
    ``TENSOR_FIELDS`` to a NumPy array, ``statics`` every name in
    ``STATIC_FIELDS`` to its value. The arrays of another package's
    uploaded scene, converted to NumPy, carry its state across."""
    pool_mode = statics["pool_mode"]
    if pool_mode != "quad":
        raise _not_ported(f"pool_mode={pool_mode!r}",
                          _SLICE_POOL.get(pool_mode, "unknown mode"))
    tensors = {f: torch.tensor(np.asarray(leaves[f]), device=device)
               for f in TENSOR_FIELDS}
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


def setup_packed_cols(scene: DeviceScene, clip, width: int, height: int,
                      opacity_split: bool = False):
    """Per-triangle setup + forward-attribute planes → (cols (33, Tp)
    f32 column-major in the layout of ``raster``'s module docstring,
    bbox (xmin, xmax, ymin, ymax, zmin) each (Tp/32,) at group
    granularity, over valid triangles only).

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
                      cmin(sz, v))                        # (33, Tp), bbox

    if opacity_split:
        return (finish(torch.where(opq, bias[0], rs.REJECT), valid & opq),
                finish(torch.where(opq, rs.REJECT, bias[0]), valid & ~opq))
    return finish(bias[0], valid)


def _mat_select(mat_color, tri_material) -> torch.Tensor:
    """Per-triangle material color → (4, Tp) f32."""
    return mat_color[tri_material.long()].T


# ------------------------------------------------------------ tap shade


def _tap_albedo_channels(pool, idx, fx, fy) -> list:
    """One quad-pool gather + the 2x2 bilinear contraction → 4 albedo
    channel tensors shaped like ``idx``."""
    if pool.shape[-1] != 16:
        raise ValueError("the tap shade needs the quad (16 B/texel) pool")
    quad = pool[idx.clamp(min=0).long()].reshape(idx.shape + (4, 4))
    quad = quad.to(torch.float32)                         # (..., corner, ch)
    wq = [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy]
    return [wq[0] * quad[..., 0, c] + wq[1] * quad[..., 1, c]
            + wq[2] * quad[..., 2, c] + wq[3] * quad[..., 3, c]
            for c in range(4)]


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
                       raster=rs.raster_fwd):
    """Frame body → (packed color (H, W) i32, depth (H, W) f32,
    (n_over, n_over_tap) device counts). ``raster`` is the raster stage;
    passing ``raster.raster_fwd_reference`` renders the same frame
    through the plain version on any device."""
    pw, ph = _padded(width, height)
    clip = vertex_stage(scene, view_proj, bone_mats)
    cols, bbox = setup_packed_cols(scene, clip, width, height)
    lists, glists, counts, n_over = rs.prebin(
        cols, bbox, 0, 0, width=pw, height=ph,
        maxc=maxc or rs.MAXC_DEFAULT)
    zb, ib, tattrs, tapidx = raster(cols, lists, glists, counts, (0, 0),
                                    width=pw, height=ph, w_eps=W_EPS)
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

    ``packed``: color is (H, W) int32 holding RGBA8 bits; otherwise it
    is the (H, W, 4) uint8 view of the same plane."""
    if backend != "pallas":
        raise _by_decision(f"backend={backend!r}", _WHY_SCAN)
    if mipmap:
        raise _not_ported("mipmap=True", _SLICE_MIP)
    if lighting:
        raise _not_ported("lighting=True", _SLICE_LIGHT)
    if scene.pool_mode != "quad":
        raise _not_ported(f"pool_mode={scene.pool_mode!r}",
                          _SLICE_POOL.get(scene.pool_mode, "unknown mode"))
    color, depth, n_over = _render_frame_core(
        scene, view_proj, bone_mats, width=width, height=height,
        clear_color=clear_color, maxc=maxc, tap_tiles=tap_tiles)
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
                           maxc: int | None = None, margin: float = 1.5,
                           mode: str = "ml", bands: int = 1):
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
    peel_mode="split")`` takes."""
    if bands > 1:
        raise _not_ported("measure_live_tap_tiles(bands > 1)",
                          "slice 6 (ROADMAP Queue 1 item 18)")
    if mode not in ("ml", "split"):
        raise ValueError(f"unknown mode {mode!r}")
    pw, ph = _padded(width, height)
    nrows = (pw // rs.TILE_W) * (ph // (SEG_PX // rs.TILE_W))
    mc = maxc or rs.MAXC_DEFAULT
    kw = dict(width=pw, height=ph, w_eps=W_EPS)
    clip = vertex_stage(scene, view_proj, bone_mats)

    def cap(live: int, hi: int) -> int:
        return min(max(8, -(-int(np.ceil(live * margin)) // 8) * 8), hi)

    if mode == "split":
        (_, io, _, tio), (_, it, _, tit), front, _ = _split_rasters(
            *setup_packed_cols(scene, clip, width, height,
                               opacity_split=True),
            pw=pw, ph=ph, layers=layers, maxc=mc)
        live_op, live_tr = torch.stack(
            [_live_rows((io >= 0) & (tio >= 0)),
             _live_rows(front & (tit >= 0))]).tolist()
        return cap(live_op, nrows), cap(live_tr, nrows * layers)

    cols, bbox = setup_packed_cols(scene, clip, width, height)
    lists, glists, counts, _ = rs.prebin(cols, bbox, 0, 0, width=pw,
                                         height=ph, maxc=mc)
    _, il, _, ti = rs.raster_fwd_ml(cols, lists, glists, counts, (0, 0),
                                    layers=layers, opaque_cull=True, **kw)
    return cap(int(_live_rows((il >= 0) & (ti >= 0))), nrows * layers)


def _split_rasters(setup_op, setup_tr, *, pw: int, ph: int, layers: int,
                   maxc: int, raster=rs.raster_fwd,
                   raster_ml=rs.raster_fwd_ml):
    """The split peel's two rasters over the padded ``pw`` x ``ph``
    frame: K1 over the opaque set, then K2 over the translucent set
    (variant "nocull") with the opaque z-buffer as its ``zhi`` horizon.
    ``setup_op``/``setup_tr`` are the (cols, bbox) pairs of
    ``setup_packed_cols(opacity_split=True)``.

    Returns (K1's (z, ids, tattrs, tapidx), K2's (zl, il, tattrs,
    tapidx), front (n_tiles, L, P) bool: the translucent fragments kept
    and in front of the opaque winner under the exact (z asc, id desc)
    order, the device count of tiles over ``maxc`` in either binning)."""
    kw = dict(width=pw, height=ph, w_eps=W_EPS)
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
    rasters of ``_split_rasters``, the opaque tap shade and blend, then
    the translucent layers in front of the opaque winner composited over
    it. ``tap_tiles`` is one cap or the (opaque, translucent) pair.

    Returns (channels [r, g, b, a] each (n_tiles, P) f32 tile-major, z0
    (n_tiles, P) nearest depth with 1.0 where empty, (n_over bins,
    n_over taps))."""
    if mipmap:
        raise _not_ported("the split peel's mip-tap composite",
                          _SLICE_MIP)
    if light is not None:
        raise _not_ported("the split peel's lit epilogue",
                          _SLICE_LIGHT)
    (zo, io, tat_op, tid_op), (zt, it, tat_tr, tid_tr), front, nov = \
        _split_rasters(setup_op, setup_tr, pw=pw, ph=ph, layers=layers,
                       maxc=maxc, raster=raster, raster_ml=raster_ml)
    cap_op, cap_tr = (tap_tiles if isinstance(tap_tiles, tuple)
                      else (tap_tiles, tap_tiles))
    src_op, cov_op, novt_op = shade_tap_flat_channels(
        scene, tat_op, tid_op, io, tap_tiles=cap_op)
    dst, novt_tr = composite_peeled_tap_flat(
        scene, tat_tr, tid_tr, it, layers, clear_color, tap_tiles=cap_tr,
        covered=front, dst0=_blend_channels(src_op, cov_op, clear_color))
    inf = float("inf")
    z0 = torch.minimum(torch.where(it[:, 0] >= 0, zt[:, 0], inf),
                       torch.where(io[:, 0] >= 0, zo[:, 0], inf))
    z0 = torch.where(torch.isfinite(z0), z0, 1.0)
    return dst, z0, (nov, novt_op + novt_tr)


def _render_frame_peeled_core(scene: DeviceScene, view_proj, bone_mats=None,
                              *, width: int, height: int, layers: int,
                              clear_color: tuple, maxc: int | None,
                              peel_mode: str, tap_tiles,
                              raster=rs.raster_fwd,
                              raster_ml=rs.raster_fwd_ml):
    """Peeled frame body → (packed color (H, W) i32, nearest depth
    (H, W) f32, (n_over, n_over_tap) device counts). ``raster`` and
    ``raster_ml`` are the K1 and K2 stages; passing their plain versions
    renders the same frame through them on any device."""
    pw, ph = _padded(width, height)
    mc = maxc or rs.MAXC_DEFAULT
    clip = vertex_stage(scene, view_proj, bone_mats)
    if peel_mode == "split":
        setup_op, setup_tr = setup_packed_cols(scene, clip, width, height,
                                               opacity_split=True)
        dst, z0, n_over = _split_peel_flat(
            scene, setup_op, setup_tr, pw=pw, ph=ph, layers=layers,
            maxc=mc, tap_tiles=tap_tiles, clear_color=clear_color,
            raster=raster, raster_ml=raster_ml)
    else:
        cols, bbox = setup_packed_cols(scene, clip, width, height)
        lists, glists, counts, nov = rs.prebin(cols, bbox, 0, 0, width=pw,
                                               height=ph, maxc=mc)
        zl, il, tattrs, tapidx = raster_ml(
            cols, lists, glists, counts, (0, 0), width=pw, height=ph,
            layers=layers, w_eps=W_EPS, opaque_cull=True)
        dst, novt = composite_peeled_tap_flat(
            scene, tattrs, tapidx, il, layers, clear_color,
            tap_tiles=tap_tiles)
        z0 = zl[:, 0, :]
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
    if mipmap:
        raise _not_ported("mipmap=True", _SLICE_MIP)
    if lighting:
        raise _not_ported("lighting=True", _SLICE_LIGHT)
    if scene.pool_mode != "quad":
        raise _not_ported(f"pool_mode={scene.pool_mode!r}",
                          _SLICE_POOL.get(scene.pool_mode, "unknown mode"))
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
        peel_mode=peel_mode, tap_tiles=tap_tiles)
    if check_overflow:
        _queue_frame_overflow(n_over, maxc, tap_tiles, width, height)
    if not packed:
        color = color.view(torch.uint8).reshape(height, width, 4)
    return color, depth
