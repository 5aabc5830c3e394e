"""Scene assembly: parsed assets → flat draw batch.

This is the analog of the reference's GPU scene construction
(``src/model.rs:36-293``): resolve material → albedo
texture, decode each primitive's vertices by its input layout, expand
triangle strips, and emit one *batch* of device-friendly arrays.  Where the
reference builds one ``wgpu::RenderPipeline`` per distinct
``(vertex_stride, material_no, inputlayout)`` key (``model.rs:25,160-267``),
the TPU pipeline consumes a single batched triangle soup with per-triangle
material/texture ids — permutations become data, not compiled state.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import dti as dti_mod
from ..formats.mfx import ObjectType, Shader2File
from ..formats.mod import ModelFile
from ..formats.mrl import MaterialFile
from ..formats.tex import TextureFile
from ..render.vertex import decode_vertices, gather_streams, strip_to_triangles

# the 20-color joint/debug palette from the reference fragment shader
# (shaders/debug_ids.wgsl:23-46), rgb 0-255
DEBUG_PALETTE = np.array([
    [215, 62, 103], [95, 190, 80], [133, 95, 213], [180, 184, 53],
    [213, 87, 180], [72, 138, 55], [145, 79, 158], [91, 196, 153],
    [206, 78, 55], [74, 174, 209], [225, 133, 58], [92, 122, 198],
    [207, 162, 81], [188, 144, 216], [152, 173, 92], [161, 71, 103],
    [53, 133, 98], [225, 131, 152], [111, 111, 40], [162, 99, 55],
], dtype=np.uint8)


@dataclass
class DrawBatch:
    """Unified triangle soup + attributes for one model."""

    positions: np.ndarray          # (V, 3) f32
    uvs: np.ndarray                # (V, 2) f32
    # normals filled post-init when the layout has them (V, 3) f32
    joints: np.ndarray             # (V, W) i32 bone indices, W ∈ {4, 8}
    weights: np.ndarray            # (V, W) f32
    tris: np.ndarray               # (T, 3) i32 into the pooled vertices
    tri_texture: np.ndarray        # (T,) i32 texture id, -1 = untextured
    tri_parts: np.ndarray          # (T,) i32 parts_no (visibility culling)
    tri_debug_id: np.ndarray       # (T,) i32 joint debug id
    tri_material: np.ndarray = None  # (T,) i32 material slot (0 default)
    tri_flat: np.ndarray = None    # (T, 4) f32 0-255 flat color; alpha<0 = unused
    textures: list[np.ndarray] = field(default_factory=list)  # (H,W,4) u8 each
    # skinning inputs
    material_names: list = field(default_factory=list)  # slot -> name
    inverse_bind_mats: np.ndarray = None   # (J, 4, 4) f32
    joint_parents: np.ndarray = None       # (J,) i32, -1 = root
    joint_offsets: np.ndarray = None       # (J, 3) f32
    skinned: bool = False
    normals: np.ndarray = None     # (V, 3) f32 or None

    def normals_or_zero(self) -> np.ndarray:
        if self.normals is None:
            return np.zeros((self.num_vertices, 3), np.float32)
        return self.normals

    @property
    def num_materials(self) -> int:
        return max(len(self.material_names), 1)

    def material_ids(self) -> np.ndarray:
        if self.tri_material is None:
            return np.zeros(self.num_triangles, np.int32)
        return self.tri_material[: self.num_triangles]

    @property
    def num_vertices(self) -> int:
        return len(self.positions)

    @property
    def num_triangles(self) -> int:
        return len(self.tris)


def build_draw_batch(
    model: ModelFile,
    material: MaterialFile | None,
    shader2: Shader2File,
    resource_manager=None,
    parts_disp: list[bool] | None = None,
) -> DrawBatch:
    # material name -> albedo texture index (model.rs:60-75)
    mat_to_tex: list[int | None] = []
    for name in model.material_names:
        info = material.material_by_name(name) if material else None
        mat_to_tex.append(info.albedo_texture_idx if info else None)

    # load + decode referenced textures once (model.rs:46-58)
    textures: list[np.ndarray] = []
    tex_remap: dict[int, int] = {}
    if material is not None and resource_manager is not None:
        for i, path in enumerate(material.textures):
            try:
                res = resource_manager.get_resource(
                    path.replace("\\", "/"), dti_mod.from_name("rTexture")
                )
                textures.append(TextureFile(res.read()).decode_rgba8())
                tex_remap[i] = len(textures) - 1
            except FileNotFoundError:
                pass

    pos_parts, uv_parts, nrm_parts, joint_parts, weight_parts = [], [], [], [], []
    any_normals = False
    tri_parts_, tri_tex, tri_part_no, tri_debug, tri_mat = [], [], [], [], []
    vert_base = 0
    any_skin = False

    vbuf = model.vertex_buf
    for prim in model.primitives:
        il_obj = shader2.get_object_by_handle(prim.inputlayout)
        if il_obj is None or il_obj.obj_type != ObjectType.INPUTLAYOUT:
            raise ValueError(
                f"primitive inputlayout {prim.inputlayout:08x} not found"
            )
        attrs = decode_vertices(
            vbuf, prim.vertex_base, prim.vertex_stride, prim.vertex_num,
            il_obj.specific.elements,
        )
        n = prim.vertex_num
        pos = attrs.get("Position")
        if pos is None:
            raise ValueError(f"inputlayout {il_obj.name} has no Position")
        if pos.shape[1] < 3:
            pos = np.pad(pos, ((0, 0), (0, 3 - pos.shape[1])))
        pos_parts.append(pos[:, :3].astype(np.float32))

        uv = attrs.get("TexCoord")
        uv_parts.append(
            uv[:, :2].astype(np.float32) if uv is not None
            else np.zeros((n, 2), np.float32)
        )

        nrm = attrs.get("Normal")
        if nrm is not None and nrm.shape[1] >= 3:
            any_normals = True
            nrm_parts.append(nrm[:, :3].astype(np.float32))
        else:
            nrm_parts.append(np.zeros((n, 3), np.float32))

        jn = gather_streams(attrs, "Joint")                # all streams
        wt = gather_streams(attrs, "Weight")
        if jn is not None and prim.weight_num > 0:
            any_skin = True
            # layouts carry weight_num up to 31 (rmodel.rs:186-188) across
            # multiple Joint/Weight streams; keep every decoded influence
            # (width settles batch-wide below)
            wn = jn.shape[1]
            jw = jn[:, :wn].astype(np.int32)
            ww = np.zeros((n, wn), np.float32)
            if wt is not None:
                m = min(wn, wt.shape[1])
                ww[:, :m] = wt[:, :m].astype(np.float32)
            else:
                ww[:, 0] = 1.0
            # renormalise (engine data stores quantised weights)
            s = ww.sum(axis=1, keepdims=True)
            ww = np.where(s > 0, ww / np.maximum(s, 1e-8), ww)
            joint_parts.append(jw)
            weight_parts.append(ww)
        else:
            joint_parts.append(np.zeros((n, 4), np.int32))
            weight_parts.append(np.zeros((n, 4), np.float32))

        indices = model.index_buf[prim.index_ofs:prim.index_ofs + prim.index_num]
        tris = strip_to_triangles(indices, prim.index_base) + vert_base
        tri_parts_.append(tris)

        t = len(tris)
        raw_tex = mat_to_tex[prim.material_no]
        tex_id = tex_remap.get(raw_tex, -1) if raw_tex is not None else -1
        tri_tex.append(np.full(t, tex_id, np.int32))
        tri_mat.append(np.full(t, prim.material_no, np.int32))
        tri_part_no.append(np.full(t, prim.parts_no, np.int32))
        # debug id = joint of the primitive's boundary (model.rs:139-157)
        if len(model.boundaries):
            debug_id = int(model.boundaries[prim.boundary_num]["joint"])
        else:
            debug_id = 0
        tri_debug.append(np.full(t, debug_id, np.int32))

        vert_base += n

    # unify influence width across primitives (4 or 8 — device arrays
    # need one static width; 8 covers MT's multi-stream skin layouts)
    if joint_parts:
        wmax = max(p.shape[1] for p in joint_parts)
        width = 4 if wmax <= 4 else 8

        def padw(p, dtype):
            if p.shape[1] == width:
                return p
            out = np.zeros((p.shape[0], width), dtype)
            out[:, : min(width, p.shape[1])] = p[:, :width]
            return out

        joint_parts = [padw(p, np.int32) for p in joint_parts]
        weight_parts = [padw(p, np.float32) for p in weight_parts]

    batch = DrawBatch(
        positions=np.concatenate(pos_parts) if pos_parts else np.zeros((0, 3), np.float32),
        uvs=np.concatenate(uv_parts) if uv_parts else np.zeros((0, 2), np.float32),
        joints=np.concatenate(joint_parts) if joint_parts else np.zeros((0, 4), np.int32),
        weights=np.concatenate(weight_parts) if weight_parts else np.zeros((0, 4), np.float32),
        tris=np.concatenate(tri_parts_) if tri_parts_ else np.zeros((0, 3), np.int32),
        tri_texture=np.concatenate(tri_tex) if tri_tex else np.zeros(0, np.int32),
        tri_parts=np.concatenate(tri_part_no) if tri_part_no else np.zeros(0, np.int32),
        tri_debug_id=np.concatenate(tri_debug) if tri_debug else np.zeros(0, np.int32),
        tri_material=np.concatenate(tri_mat) if tri_mat else np.zeros(0, np.int32),
        material_names=list(model.material_names),
        textures=textures,
        skinned=any_skin,
    )
    if any_normals:
        batch.normals = np.concatenate(nrm_parts)

    if model.joints:
        batch.inverse_bind_mats = model.inverse_bind_mats.astype(np.float32)
        batch.joint_parents = np.array(
            [j.parent if j.parent != 255 else -1 for j in model.joints], np.int32
        )
        batch.joint_offsets = np.stack([j.offset for j in model.joints])

    if parts_disp is not None:
        keep = np.array(
            [parts_disp[p] if p < len(parts_disp) else True
             for p in batch.tri_parts], dtype=bool,
        )
        batch.tris = batch.tris[keep]
        batch.tri_texture = batch.tri_texture[keep]
        batch.tri_parts = batch.tri_parts[keep]
        batch.tri_debug_id = batch.tri_debug_id[keep]
        batch.tri_material = batch.tri_material[keep]

    return batch


class Model:
    """High-level scene object mirroring the reference ``Model`` API."""

    def __init__(self, model_file, material_file, shader2, resource_manager,
                 parts_disp=None):
        self.model_file = model_file
        self.material_file = material_file
        self.shader2 = shader2
        self.resource_manager = resource_manager
        self.parts_disp = parts_disp
        self.batch = build_draw_batch(
            model_file, material_file, shader2, resource_manager, parts_disp
        )

    def set_parts_disp(self, parts_disp):
        """Host-side rebuild (drops hidden triangles from the batch).
        For per-frame toggling of an uploaded scene use
        ``render.device.set_parts_mask`` — it swaps only the (P,) bool
        mask, no re-upload (model.rs:318-320 semantics)."""
        self.parts_disp = list(parts_disp)
        self.batch = build_draw_batch(
            self.model_file, self.material_file, self.shader2,
            self.resource_manager, self.parts_disp,
        )

    @property
    def skeleton(self):
        from .skeleton import Skeleton

        if not hasattr(self, "_skeleton"):
            self._skeleton = Skeleton.from_model(self.model_file)
        return self._skeleton

    def joint_world_positions(self, deltas=None) -> np.ndarray:
        """World joint origins (overlay feed, model.rs:309-315)."""
        sk = self.skeleton
        if sk is None:
            return np.zeros((0, 3), np.float32)
        return sk.joint_world_positions(deltas)


def merge_batches(a: DrawBatch, b: DrawBatch,
                  keep_b_skin: bool = False) -> DrawBatch:
    """Concatenate two batches; b's texture ids remap into a's atlas.

    Used to composite overlay geometry (the analog of the reference's
    second render pass, debug_overlay.rs:202) and to assemble whole-
    archive scenes. Skinning data (palette indices) follows ``a``; by
    default b's vertices merge unskinned (zero weights → positions pass
    through the vertex stage untouched). ``keep_b_skin=True`` keeps b's
    weights/joints only when both batches share a's skeleton.
    """
    def flat(batch):
        if batch.tri_flat is not None:
            return batch.tri_flat
        return np.full((batch.num_triangles, 4), -1.0, np.float32)

    va = a.num_vertices
    ntex_a = len(a.textures)
    b_tex = np.where(b.tri_texture >= 0, b.tri_texture + ntex_a, -1)
    nmat_a = a.num_materials
    b_mat = b.material_ids() + nmat_a
    wa = a.joints.shape[1] if a.num_vertices else 4
    if keep_b_skin:
        # widen the merged influence layout to cover BOTH batches —
        # truncating b's wider skin to a's width would drop weights
        # without renormalizing (underweighted blend → vertices
        # collapse toward the origin)
        wm = max(wa, b.joints.shape[1] if b.num_vertices else 0)
        b_joints = np.zeros((b.num_vertices, wm), np.int32)
        b_weights = np.zeros((b.num_vertices, wm), np.float32)
        mb = b.joints.shape[1]
        b_joints[:, :mb] = b.joints.astype(np.int32)
        b_weights[:, :mb] = b.weights.astype(np.float32)
    else:
        wm = wa
        b_joints = np.zeros((b.num_vertices, wm), np.int32)
        b_weights = np.zeros((b.num_vertices, wm), np.float32)
    a_joints = a.joints.astype(np.int32)
    a_weights = a.weights.astype(np.float32)
    if wm > wa:
        a_joints = np.pad(a_joints, ((0, 0), (0, wm - wa)))
        a_weights = np.pad(a_weights, ((0, 0), (0, wm - wa)))
    return DrawBatch(
        positions=np.concatenate([a.positions, b.positions]),
        uvs=np.concatenate([a.uvs, b.uvs]),
        joints=np.concatenate([a_joints, b_joints]),
        weights=np.concatenate([a_weights, b_weights]),
        tris=np.concatenate([a.tris, b.tris + va]),
        tri_texture=np.concatenate([a.tri_texture, b_tex]).astype(np.int32),
        tri_material=np.concatenate([a.material_ids(), b_mat]).astype(np.int32),
        material_names=(
            list(a.material_names) + [""] * (nmat_a - len(a.material_names))
            + list(b.material_names)
            + [""] * (b.num_materials - len(b.material_names))
        ),
        # b's parts shift past a's so each sub-batch keeps independent
        # visibility toggles in the merged scene (device.set_parts_mask)
        tri_parts=np.concatenate([
            a.tri_parts,
            b.tri_parts + (int(a.tri_parts.max()) + 1 if len(a.tri_parts) else 0),
        ]).astype(np.int32),
        tri_debug_id=np.concatenate([a.tri_debug_id, b.tri_debug_id]),
        tri_flat=np.concatenate([flat(a), flat(b)]).astype(np.float32),
        textures=list(a.textures) + list(b.textures),
        inverse_bind_mats=a.inverse_bind_mats,
        joint_parents=a.joint_parents,
        joint_offsets=a.joint_offsets,
        skinned=a.skinned,
        normals=(
            np.concatenate([a.normals_or_zero(), b.normals_or_zero()])
            if (a.normals is not None or b.normals is not None) else None
        ),
    )


def merge_many(batches: list[DrawBatch],
               skeleton_from: int | None = None) -> DrawBatch:
    """N-way batch merge in one concatenation pass (linear, where a
    ``merge_batches`` fold copies quadratically — archive-world scenes
    merge hundreds of parsed models).

    Offsets follow ``merge_batches``: texture ids remap into a shared
    list (deduplicated by array identity, so V instances of one variant
    share one texel-pool entry), material slots and parts ids shift by
    each predecessor's count. Joint INDICES are kept verbatim — callers
    instancing skinned models pre-shift them into the combined palette
    (``world.py`` gives character i joints ``8i..8i+7``); unskinned
    batches carry zero weights and pass through the vertex stage
    untouched. Skeleton metadata comes from ``skeleton_from`` (default:
    the first skinned batch)."""
    if not batches:
        raise ValueError("merge_many needs at least one batch")
    wm = max((b.joints.shape[1] if b.num_vertices else 0)
             for b in batches) or 4
    tex_idx: dict[int, int] = {}
    textures: list[np.ndarray] = []
    tex_maps = []
    for b in batches:
        remap = np.empty(max(len(b.textures), 1), np.int32)
        for i, t in enumerate(b.textures):
            if id(t) not in tex_idx:
                tex_idx[id(t)] = len(textures)
                textures.append(t)
            remap[i] = tex_idx[id(t)]
        tex_maps.append(remap)

    if skeleton_from is None:
        skeleton_from = next(
            (i for i, b in enumerate(batches) if b.skinned), 0)
    sk = batches[skeleton_from]

    def flat(b):
        if b.tri_flat is not None:
            return b.tri_flat
        return np.full((b.num_triangles, 4), -1.0, np.float32)

    def wide(arr, b, dtype):
        w = b.joints.shape[1] if b.num_vertices else wm
        if w == wm:
            return arr.astype(dtype)
        return np.pad(arr.astype(dtype), ((0, 0), (0, wm - w)))

    pos, uv, jn, wt, nrm = [], [], [], [], []
    tris, ttex, tmat, tparts, tdbg, tflat = [], [], [], [], [], []
    names: list = []
    v0 = 0
    mat0 = 0
    part0 = 0
    any_normals = any(b.normals is not None for b in batches)
    for bi, b in enumerate(batches):
        pos.append(b.positions)
        uv.append(b.uvs)
        jn.append(wide(b.joints, b, np.int32))
        wt.append(wide(b.weights, b, np.float32))
        if any_normals:
            nrm.append(b.normals_or_zero())
        tris.append(b.tris + v0)
        t = b.tri_texture
        ttex.append(np.where(t >= 0, tex_maps[bi][np.maximum(t, 0)], -1))
        tmat.append(b.material_ids() + mat0)
        tparts.append(b.tri_parts + part0)
        tdbg.append(b.tri_debug_id)
        tflat.append(flat(b))
        names += (list(b.material_names)
                  + [""] * (b.num_materials - len(b.material_names)))
        v0 += b.num_vertices
        mat0 += b.num_materials
        part0 += int(b.tri_parts.max()) + 1 if len(b.tri_parts) else 1

    def cat(parts, dtype=None):
        out = np.concatenate(parts) if parts else np.zeros(0)
        return out.astype(dtype) if dtype is not None else out

    return DrawBatch(
        positions=cat(pos, np.float32), uvs=cat(uv, np.float32),
        joints=cat(jn, np.int32), weights=cat(wt, np.float32),
        tris=cat(tris, np.int32), tri_texture=cat(ttex, np.int32),
        tri_material=cat(tmat, np.int32), tri_parts=cat(tparts, np.int32),
        tri_debug_id=cat(tdbg, np.int32),
        tri_flat=cat(tflat, np.float32),
        textures=textures, material_names=names,
        inverse_bind_mats=sk.inverse_bind_mats,
        joint_parents=sk.joint_parents,
        joint_offsets=sk.joint_offsets,
        skinned=any(b.skinned for b in batches),
        normals=cat(nrm, np.float32) if any_normals else None,
    )
