"""Synthetic asset builders: the ones the demo scene and the archive
world call.

No real game data ships with (or may be added to) this repo, so the
scenes are built from tiny, valid, deterministically generated assets: a
textured/skinned model (plain, packed-attribute or 8-weight), its
material + shader metadata, an RGBA8 texture and a bone-animation
scheduler. The bytes equal the JAX package's builders'.

The geometry is a unit cube built from triangle strips (two strips with a
0xffff restart in one of them, exercising strip semantics), UV-mapped into
a checkerboard texture, with two bones for the skinned variant.
"""

from __future__ import annotations

import numpy as np

from . import dti as dti_mod
from .formats import mfx, mrl, sdl, tex
from .formats.mod import Joint, Primitive, write_model

INPUTLAYOUT_STATIC = "IL_FixtureP3T2"
INPUTLAYOUT_SKIN = "IL_FixtureSkin"
INPUTLAYOUT_RICH = "IL_FixtureRich"   # packed normals + u16n uvs
INPUTLAYOUT_SKIN8 = "IL_FixtureSkin8"  # two Joint/Weight streams (8 influences)
TEXTURE_PATH = "model\\fixture_albedo"


def checkerboard_rgba(size: int = 64, cells: int = 8) -> np.ndarray:
    """(size, size, 4) uint8 checkerboard with a red/blue gradient."""
    y, x = np.mgrid[0:size, 0:size]
    cell = ((x // (size // cells)) + (y // (size // cells))) % 2
    img = np.zeros((size, size, 4), dtype=np.uint8)
    img[..., 0] = np.where(cell, 230, 30) - (y * 16 // size)
    img[..., 1] = np.where(cell, 200, 60)
    img[..., 2] = np.where(cell, 40, 220) - (x * 16 // size)
    img[..., 3] = 255
    return img


def build_texture_rgba(size: int = 64) -> bytes:
    img = checkerboard_rgba(size)
    return tex.write_texture(size, size, int(tex.TextureFormat.RGBA8),
                             [img.tobytes()])


def build_shader2() -> bytes:
    """Shader metadata: input layouts + the state/sampler objects materials
    reference (blend/depth/raster handles, tAlbedoMap)."""
    w = mfx.Shader2Writer()
    F = mfx.InputElementFormat
    w.add_inputlayout(INPUTLAYOUT_STATIC, 20, [
        mfx.InputElement("Position", 0, F.IEF_F32, 3, 0, 0, 0),
        mfx.InputElement("TexCoord", 0, F.IEF_F32, 2, 0, 12, 0),
    ])
    w.add_inputlayout(INPUTLAYOUT_SKIN, 28, [
        mfx.InputElement("Position", 0, F.IEF_F32, 3, 0, 0, 0),
        mfx.InputElement("TexCoord", 0, F.IEF_F32, 2, 0, 12, 0),
        mfx.InputElement("Joint", 0, F.IEF_U8, 4, 0, 20, 0),
        mfx.InputElement("Weight", 0, F.IEF_U8N, 4, 0, 24, 0),
    ])
    w.add_inputlayout(INPUTLAYOUT_RICH, 20, [
        mfx.InputElement("Position", 0, F.IEF_F32, 3, 0, 0, 0),
        mfx.InputElement("Normal", 0, F.IEF_SCMP3N, 3, 0, 12, 0),
        mfx.InputElement("TexCoord", 0, F.IEF_U16N, 2, 0, 16, 0),
    ])
    # heavy-skin layout: duplicate Joint/Weight semantics on stream 1
    # (the multi-stream pattern of rshader2.rs:425-450)
    w.add_inputlayout(INPUTLAYOUT_SKIN8, 36, [
        mfx.InputElement("Position", 0, F.IEF_F32, 3, 0, 0, 0),
        mfx.InputElement("TexCoord", 0, F.IEF_F32, 2, 0, 12, 0),
        mfx.InputElement("Joint", 0, F.IEF_U8, 4, 0, 20, 0),
        mfx.InputElement("Weight", 0, F.IEF_U8N, 4, 0, 24, 0),
        mfx.InputElement("Joint", 1, F.IEF_U8, 4, 0, 28, 0),
        mfx.InputElement("Weight", 1, F.IEF_U8N, 4, 0, 32, 0),
    ])
    T = mfx.ObjectType
    w.add_object("BSSolid", T.BLEND)
    w.add_object("BSBlendAlpha", T.BLEND)
    w.add_object("DSZTestWriteLEq", T.DEPTHSTENCIL)
    w.add_object("RSMeshCN", T.RASTERIZER)
    w.add_object("tAlbedoMap", T.TEXTURE)
    w.add_object("SSAlbedoMap", T.SAMPLER)
    w.add_object("CBMaterial", T.CBUFFER, cbuffer_vars=[
        ("fAlbedoColor", mfx.ClassType.CT_VECTOR, 4, 0),
    ])
    return w.tobytes()


def _cube_mesh():
    """Unit cube as two triangle strips over 8 shared corners, with UVs.

    Strip A covers +X/-X/+Y/-Y via a classic 10-vertex wrap; strip B covers
    +Z/-Z and includes a 0xffff restart between the two faces.
    """
    corners = np.array([
        [-1, -1, -1], [1, -1, -1], [-1, 1, -1], [1, 1, -1],
        [-1, -1, 1], [1, -1, 1], [-1, 1, 1], [1, 1, 1],
    ], dtype=np.float32)
    # per-vertex UVs (corner projected)
    uvs = (corners[:, :2] * 0.5 + 0.5).astype(np.float32)

    # wrap strip around 4 sides: winding chosen for CCW front faces outward
    strip_a = np.array([0, 1, 4, 5, 6, 7, 2, 3, 0, 1], dtype=np.uint16)
    strip_b = np.array([1, 3, 5, 7, 0xFFFF, 2, 0, 6, 4], dtype=np.uint16)
    return corners, uvs, strip_a, strip_b


def _pack_model(positions: np.ndarray, uvs: np.ndarray,
                index_stream: np.ndarray, skinned: bool) -> bytes:
    """Pack arbitrary strip geometry into a one-primitive model."""
    nverts = len(positions)
    if skinned:
        stride, layout, weight_num = 28, INPUTLAYOUT_SKIN, 1
    else:
        stride, layout, weight_num = 20, INPUTLAYOUT_STATIC, 0
    vbuf = np.zeros((nverts, stride), dtype=np.uint8)
    vbuf[:, 0:12] = positions.astype("<f4").view(np.uint8).reshape(nverts, 12)
    vbuf[:, 12:20] = uvs.astype("<f4").view(np.uint8).reshape(nverts, 8)
    joints = []
    imats = None
    if skinned:
        bone = (positions[:, 2] > 0).astype(np.uint8)
        vbuf[:, 20] = bone
        vbuf[:, 24] = 255
        joints = [
            Joint(no=0, parent=255, symmetry=0, radius=1.0, length=1.0,
                  offset=np.array([0, 0, -1], np.float32)),
            Joint(no=1, parent=0, symmetry=1, radius=1.0, length=1.0,
                  offset=np.array([0, 0, 1], np.float32)),
        ]
        imats = np.tile(np.eye(4, dtype="<f4"), (2, 1, 1))
    prim = Primitive(
        draw_mode=0, vertex_num=nverts, parts_no=0, material_no=0,
        lod=0xFF, weight_num=weight_num, alphapri=0, vertex_stride=stride,
        topology=4, vertex_ofs=0, vertex_base=0,
        inputlayout=mfx.object_handle(layout),
        index_ofs=0, index_num=len(index_stream), index_base=0,
        envelope=0, boundary_num=0, connect_id=0,
        min_index=0, max_index=nverts - 1,
        disp=True, shape=False, sort=False,
        binormal_flip=False, bridge=False,
    )
    return write_model(
        material_names=["fixture_mat"],
        primitives=[prim],
        vertex_buf=vbuf.tobytes(),
        index_buf=index_stream,
        joints=joints,
        inverse_bind_mats=imats,
    )


def _subdivided_cube(n: int):
    """Unit cube with each face an n×n grid, one triangle strip per row.

    Returns (positions (V,3), uvs (V,2), index stream with 0xffff
    restarts between rows). Winding is CCW seen from outside (front
    faces outward under the renderer's cull rule).
    """
    import itertools

    verts, uvs, strips = [], [], []
    axes = np.eye(3, dtype=np.float32)
    for axis, sign in itertools.product(range(3), (1.0, -1.0)):
        normal = axes[axis] * sign
        udir = axes[(axis + 1) % 3]
        vdir = axes[(axis + 2) % 3]
        if np.dot(np.cross(vdir, udir), normal) < 0:
            udir, vdir = vdir, udir
        base = len(verts)
        for vi in range(n + 1):
            for ui in range(n + 1):
                p = (normal + udir * (2.0 * ui / n - 1.0)
                     + vdir * (2.0 * vi / n - 1.0))
                verts.append(p)
                uvs.append([ui / n, vi / n])
        for vi in range(n):
            row = []
            for ui in range(n + 1):
                # A (this row) first, then B (next row): the first strip
                # triangle (A0,B0,A1) has normal vdir×udir = outward
                row.append(base + vi * (n + 1) + ui)
                row.append(base + (vi + 1) * (n + 1) + ui)
            strips.append(np.array(row, np.uint16))
    index = []
    for i, s in enumerate(strips):
        if i:
            index.append(np.array([0xFFFF], np.uint16))
        index.append(s)
    return (np.array(verts, np.float32), np.array(uvs, np.float32),
            np.concatenate(index))


def pack_scmp3n(normals: np.ndarray) -> np.ndarray:
    """(N, 3) float normals → packed 10:10:10 u32 (IEF_SCMP3N)."""
    q = np.clip(np.round(normals * 511.0), -511, 511).astype(np.int32)
    return (
        (q[:, 0] & 0x3FF)
        | ((q[:, 1] & 0x3FF) << 10)
        | ((q[:, 2] & 0x3FF) << 20)
    ).astype("<u4")


def build_model_rich(subdiv: int = 0) -> bytes:
    """Model using the packed-attribute layout: SCMP3N normals + U16N
    uvs (exercises the compressed vertex-decode paths end to end)."""
    if subdiv:
        positions, uvs, index_stream = _subdivided_cube(subdiv)
    else:
        corners, uvs_f, strip_a, strip_b = _cube_mesh()
        positions, uvs = corners, uvs_f
        index_stream = np.concatenate(
            [strip_a, np.array([0xFFFF], np.uint16), strip_b]
        )
    n = len(positions)
    normals = positions / np.maximum(
        np.linalg.norm(positions, axis=1, keepdims=True), 1e-6
    )
    vbuf = np.zeros((n, 20), np.uint8)
    vbuf[:, 0:12] = positions.astype("<f4").view(np.uint8).reshape(n, 12)
    vbuf[:, 12:16] = pack_scmp3n(normals).view(np.uint8).reshape(n, 4)
    uv16 = np.clip(np.round(np.asarray(uvs) * 65535.0), 0, 65535).astype("<u2")
    vbuf[:, 16:20] = uv16.view(np.uint8).reshape(n, 4)
    prim = Primitive(
        draw_mode=0, vertex_num=n, parts_no=0, material_no=0,
        lod=0xFF, weight_num=0, alphapri=0, vertex_stride=20,
        topology=4, vertex_ofs=0, vertex_base=0,
        inputlayout=mfx.object_handle(INPUTLAYOUT_RICH),
        index_ofs=0, index_num=len(index_stream), index_base=0,
        envelope=0, boundary_num=0, connect_id=0,
        min_index=0, max_index=n - 1,
        disp=True, shape=False, sort=False,
        binormal_flip=False, bridge=False,
    )
    return write_model(
        material_names=["fixture_mat"],
        primitives=[prim],
        vertex_buf=vbuf.tobytes(),
        index_buf=np.asarray(index_stream, "<u2"),
    )


def build_model(skinned: bool = False, subdiv: int = 0) -> bytes:
    """Fixture model; ``subdiv`` > 0 swaps in an n×n-per-face cube (for
    triangle-load benchmarking) while keeping the same layouts."""
    if subdiv:
        corners, uvs, index_stream = _subdivided_cube(subdiv)
        return _pack_model(corners, uvs, index_stream, skinned)
    corners, uvs, strip_a, strip_b = _cube_mesh()
    nverts = len(corners)

    if skinned:
        stride = 28
        layout = INPUTLAYOUT_SKIN
        vbuf = np.zeros((nverts, stride), dtype=np.uint8)
        vbuf[:, 0:12] = corners.astype("<f4").view(np.uint8).reshape(nverts, 12)
        vbuf[:, 12:20] = uvs.astype("<f4").view(np.uint8).reshape(nverts, 8)
        # bone 0 for z<0 corners, bone 1 for z>0, fully weighted
        bone = (corners[:, 2] > 0).astype(np.uint8)
        vbuf[:, 20] = bone
        vbuf[:, 24] = 255  # weight 1.0 on first influence
        weight_num = 1
    else:
        stride = 20
        layout = INPUTLAYOUT_STATIC
        vbuf = np.zeros((nverts, stride), dtype=np.uint8)
        vbuf[:, 0:12] = corners.astype("<f4").view(np.uint8).reshape(nverts, 12)
        vbuf[:, 12:20] = uvs.astype("<f4").view(np.uint8).reshape(nverts, 8)
        weight_num = 0

    index_buf = np.concatenate([strip_a, strip_b])
    handle = mfx.object_handle(layout)

    def prim(index_ofs, index_num, vertex_num, parts_no=0):
        return Primitive(
            draw_mode=0, vertex_num=vertex_num, parts_no=parts_no,
            material_no=0,
            lod=0xFF, weight_num=weight_num, alphapri=0, vertex_stride=stride,
            topology=4, vertex_ofs=0, vertex_base=0, inputlayout=handle,
            index_ofs=index_ofs, index_num=index_num, index_base=0,
            envelope=0, boundary_num=0, connect_id=0,
            min_index=0, max_index=vertex_num - 1,
            disp=True, shape=False, sort=False,
            binormal_flip=False, bridge=False,
        )

    # the two strips are separate parts so PartsDisp toggles are testable
    primitives = [
        prim(0, len(strip_a), nverts, parts_no=0),
        prim(len(strip_a), len(strip_b), nverts, parts_no=1),
    ]

    joints = []
    imats = None
    if skinned:
        joints = [
            Joint(no=0, parent=255, symmetry=0, radius=1.0, length=1.0,
                  offset=np.array([0, 0, -1], np.float32)),
            Joint(no=1, parent=0, symmetry=1, radius=1.0, length=1.0,
                  offset=np.array([0, 0, 1], np.float32)),
        ]
        imats = np.tile(np.eye(4, dtype="<f4"), (2, 1, 1))

    return write_model(
        material_names=["fixture_mat"],
        primitives=primitives,
        vertex_buf=vbuf.tobytes(),
        index_buf=index_buf,
        joints=joints,
        inverse_bind_mats=imats,
    )


def build_model_skin8() -> bytes:
    """Heavy-skinned fixture: the cube with 8 bone influences per vertex
    across two Joint/Weight streams (weight_num=8). Each vertex blends
    bones (v, v+1, …, v+7) mod 8 with a fixed asymmetric weight pattern,
    so a 4-weight clamp produces visibly wrong deformation."""
    corners, uvs, strip_a, strip_b = _cube_mesh()
    n = len(corners)
    stride = 36
    vbuf = np.zeros((n, stride), dtype=np.uint8)
    vbuf[:, 0:12] = corners.astype("<f4").view(np.uint8).reshape(n, 12)
    vbuf[:, 12:20] = uvs.astype("<f4").view(np.uint8).reshape(n, 8)
    # u8n weights summing to exactly 255 per vertex
    wpat = np.array([64, 48, 40, 32, 28, 20, 16, 7], np.uint8)
    for v in range(n):
        j = (np.arange(8) + v) % 8
        vbuf[v, 20:24] = j[:4]
        vbuf[v, 24:28] = wpat[:4]
        vbuf[v, 28:32] = j[4:]
        vbuf[v, 32:36] = wpat[4:]

    index_buf = np.concatenate([strip_a, strip_b])
    handle = mfx.object_handle(INPUTLAYOUT_SKIN8)
    primitives = [Primitive(
        draw_mode=0, vertex_num=n, parts_no=0, material_no=0,
        lod=0xFF, weight_num=8, alphapri=0, vertex_stride=stride,
        topology=4, vertex_ofs=0, vertex_base=0, inputlayout=handle,
        index_ofs=0, index_num=len(index_buf), index_base=0,
        envelope=0, boundary_num=0, connect_id=0,
        min_index=0, max_index=n - 1,
        disp=True, shape=False, sort=False,
        binormal_flip=False, bridge=False,
    )]
    joints = [
        Joint(no=i, parent=(255 if i == 0 else 0), symmetry=i,
              radius=1.0, length=1.0,
              offset=np.array([0, 0, 0], np.float32))
        for i in range(8)
    ]
    imats = np.tile(np.eye(4, dtype="<f4"), (8, 1, 1))
    return write_model(
        material_names=["fixture_mat"],
        primitives=primitives,
        vertex_buf=vbuf.tobytes(),
        index_buf=index_buf,
        joints=joints,
        inverse_bind_mats=imats,
    )


def build_material() -> bytes:
    return mrl.write_material(
        textures=[TEXTURE_PATH],
        materials=[{
            "name": "fixture_mat",
            "mat_type": "nDraw::MaterialStd",
            "texture_states": [("tAlbedoMap", 0)],
        }],
    )


def build_scheduler_bones(frames: int = 60) -> bytes:
    """Bone-animation timeline: joint 1 swings (joint1:rx) and slides
    (joint1:tx) over ``frames`` frames with linear keys (mode 1)."""
    import math

    tracks = [sdl.Track(sdl.TrackType.TYPE_ROOT, 0, "root", 0)]

    def float_track(name, kv):
        return sdl.Track(
            sdl.TrackType.TYPE_FLOAT, int(dti_mod.PropType.f32), name, 0,
            keys=[sdl.Key(f, 1, v) for f, v in kv],
        )

    tracks.append(float_track("joint1:rx", [
        (0, 0.0), (frames // 2, math.pi / 3), (frames, 0.0),
    ]))
    tracks.append(float_track("joint1:tx", [
        (0, 0.0), (frames // 2, 0.6), (frames, 0.0),
    ]))
    return sdl.write_scheduler(tracks)
