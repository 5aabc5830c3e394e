"""Synthetic asset builders.

No real game data ships with (or may be added to) this repo, so conformance
tests and the demo viewers run on tiny, valid, deterministically generated
assets: a textured/skinned model, its material + shader metadata, textures
(RGBA8, BC1 and BC7), a character ``.prp``, a GMD table and a scheduler —
packed loose or into an ``.arc``. The bytes equal the JAX package's
builders'.

The geometry is a unit cube built from triangle strips (two strips with a
0xffff restart in one of them, exercising strip semantics), UV-mapped into
a checkerboard texture, with two bones for the skinned variant.
"""

from __future__ import annotations

import numpy as np

from . import dti as dti_mod
from .formats import arc, gmd, mfx, mrl, sdl, spkg, tex, xfs
from .formats.mod import Joint, Primitive, write_model

INPUTLAYOUT_STATIC = "IL_FixtureP3T2"
INPUTLAYOUT_SKIN = "IL_FixtureSkin"
INPUTLAYOUT_RICH = "IL_FixtureRich"   # packed normals + u16n uvs
INPUTLAYOUT_SKIN8 = "IL_FixtureSkin8"  # two Joint/Weight streams (8 influences)
SHADER_PACKAGE_PATH = "custom_shaders\\CustomShaderPackage"
MODEL_PATH = "model\\fixture_cube"
TEXTURE_PATH = "model\\fixture_albedo"
CHARACTER_PATH = "chara\\fixture_character"


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


def encode_bc1_simple(img: np.ndarray) -> bytes:
    """Encode RGBA8 → BC1 using per-block min/max endpoints (fixture grade)."""
    h, w = img.shape[:2]
    bh, bw = h // 4, w // 4
    blocks = img[:bh * 4, :bw * 4, :3].reshape(bh, 4, bw, 4, 3)
    blocks = blocks.transpose(0, 2, 1, 3, 4).reshape(bh * bw, 16, 3).astype(np.int32)

    lum = blocks @ np.array([54, 183, 19])  # rough luma
    lo_i = np.argmin(lum, axis=1)
    hi_i = np.argmax(lum, axis=1)
    lo = np.take_along_axis(blocks, lo_i[:, None, None].repeat(3, 2), 1)[:, 0]
    hi = np.take_along_axis(blocks, hi_i[:, None, None].repeat(3, 2), 1)[:, 0]

    def to565(c):
        return ((c[:, 0] >> 3) << 11) | ((c[:, 1] >> 2) << 5) | (c[:, 2] >> 3)

    c_hi, c_lo = to565(hi), to565(lo)
    # ensure c0 > c1 (4-color mode); swap when needed
    swap = c_hi <= c_lo
    c0 = np.where(swap, c_lo, c_hi)
    c1 = np.where(swap, c_hi, c_lo)
    e0 = np.where(swap[:, None], lo, hi)
    e1 = np.where(swap[:, None], hi, lo)
    degenerate = c0 == c1

    # choose the nearest of the 4 palette entries per texel
    pal = np.stack(
        [e0, e1, (2 * e0 + e1 + 1) // 3, (e0 + 2 * e1 + 1) // 3], axis=1
    )  # (n, 4, 3)
    d = ((blocks[:, None, :, :] - pal[:, :, None, :]) ** 2).sum(-1)  # (n,4,16)
    idx = np.argmin(d, axis=1).astype(np.uint32)  # (n, 16)
    idx[degenerate] = 0

    bits = np.zeros(len(blocks), dtype=np.uint32)
    for t in range(16):
        bits |= idx[:, t] << (2 * t)

    out = np.zeros((len(blocks), 4), dtype="<u2")
    out[:, 0] = c0
    out[:, 1] = c1
    out[:, 2] = bits & 0xFFFF
    out[:, 3] = bits >> 16
    return out.tobytes()


def encode_bc7_mode5(img: np.ndarray) -> bytes:
    """Encode RGBA8 → BC7 mode 5 (single subset, 7-bit color + 8-bit
    alpha endpoints, 2-bit indices, no rotation). Fixture grade."""
    h, w = img.shape[:2]
    bh, bw = h // 4, w // 4
    blocks = (
        img[: bh * 4, : bw * 4]
        .reshape(bh, 4, bw, 4, 4)
        .transpose(0, 2, 1, 3, 4)
        .reshape(bh * bw, 16, 4)
        .astype(np.int32)
    )
    out = bytearray()
    for blk in blocks:
        rgb = blk[:, :3]
        alpha = blk[:, 3]
        lum = rgb @ np.array([54, 183, 19])
        e0 = rgb[np.argmin(lum)] >> 1          # 7-bit endpoints
        e1 = rgb[np.argmax(lum)] >> 1
        a0, a1 = int(alpha.min()), int(alpha.max())

        # decoder interpolation: (p0*(64-w) + p1*w + 32) >> 6, w in WEIGHTS[2]
        def dec(e):
            return (e << 1) | (e >> 6)

        pal = np.array([
            ((dec(e0).astype(np.int64)) * (64 - wgt)
             + dec(e1).astype(np.int64) * wgt + 32) >> 6
            for wgt in (0, 21, 43, 64)
        ])
        cidx = np.argmin(
            ((rgb[:, None, :] - pal[None, :, :]) ** 2).sum(-1), axis=1
        )
        apal = np.array([(a0 * (64 - wgt) + a1 * wgt + 32) >> 6
                         for wgt in (0, 21, 43, 64)])
        aidx = np.argmin(np.abs(alpha[:, None] - apal[None, :]), axis=1)
        # anchor texel 0 stores width-1 bits: its index must have MSB 0
        if cidx[0] >= 2:
            e0, e1 = e1, e0
            cidx = 3 - cidx
        if aidx[0] >= 2:
            a0, a1 = a1, a0
            aidx = 3 - aidx

        bits = 0
        pos = 0

        def put(v, n):
            nonlocal bits, pos
            bits |= (int(v) & ((1 << n) - 1)) << pos
            pos += n

        put(0b100000, 6)            # mode 5 prefix
        put(0, 2)                   # rotation
        for c in range(3):
            put(e0[c], 7)
            put(e1[c], 7)
        put(a0, 8)
        put(a1, 8)
        put(cidx[0], 1)
        for t in range(1, 16):
            put(cidx[t], 2)
        put(aidx[0], 1)
        for t in range(1, 16):
            put(aidx[t], 2)
        assert pos == 128
        out += bits.to_bytes(16, "little")
    return bytes(out)


def build_texture_bc7(size: int = 64) -> bytes:
    img = checkerboard_rgba(size)
    return tex.write_texture(size, size, int(tex.TextureFormat.BC7),
                             [encode_bc7_mode5(img)])


def build_texture_rgba(size: int = 64) -> bytes:
    img = checkerboard_rgba(size)
    return tex.write_texture(size, size, int(tex.TextureFormat.RGBA8),
                             [img.tobytes()])


def build_texture_bc1(size: int = 64) -> bytes:
    img = checkerboard_rgba(size)
    return tex.write_texture(size, size, int(tex.TextureFormat.BC1),
                             [encode_bc1_simple(img)])


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


def build_shader_package() -> bytes:
    return spkg.write_shader_package(
        inputs=[([mfx.object_handle(INPUTLAYOUT_STATIC), 0, 0, 0], 0x1234)],
        stage_shaders={"vs": [(b"\xde\xad\xbe\xef", 0x1)],
                       "ps": [(b"\xca\xfe", 0x2)]},
    )


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


def build_character_prp(parts_disp=(True, True), model_path=MODEL_PATH) -> bytes:
    """Character definition: mpModel resource path + PartsDisp bools."""
    spec = xfs.ClassSpec("nGO::rCharacter", [
        xfs.PropSpec("mpModel", xfs.PropType.custom, attr=xfs.PROP_ATTR_DYNAMIC),
        xfs.PropSpec("PartsDisp", xfs.PropType.bool_, attr=0),
    ])
    root = ("nGO::rCharacter", {
        "mpModel": [["rModel", model_path]],
        "PartsDisp": list(parts_disp),
    })
    return xfs.serialize(root, [spec])


def build_gmd() -> bytes:
    g = gmd.GuiMessageFile(
        language_id=0, package_name="fixture_pkg", update_time=1466708400,
        messages=[
            gmd.GuiMessage("LABEL_HELLO", "Hello, world!"),
            gmd.GuiMessage("LABEL_BYE", "Goodbye <E100>!"),
        ],
    )
    return g.tobytes()


def build_scheduler() -> bytes:
    tracks = [
        sdl.Track(sdl.TrackType.TYPE_ROOT, 0, "root", 0),
        sdl.Track(
            sdl.TrackType.TYPE_FLOAT, int(dti_mod.PropType.f32), "mAlpha", 0,
            keys=[sdl.Key(0, 0, 0.0), sdl.Key(30, 0, 1.0)],
        ),
        sdl.Track(
            sdl.TrackType.TYPE_BOOL, int(dti_mod.PropType.bool_), "mVisible", 0,
            keys=[sdl.Key(0, 0, True), sdl.Key(15, 0, False)],
        ),
    ]
    return sdl.write_scheduler(tracks)


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


def build_archive() -> bytes:
    """One .arc holding the whole fixture scene."""
    w = arc.ArchiveWriter()
    d = dti_mod.from_name
    w.add_file(SHADER_PACKAGE_PATH, d("rShader2"), 0, build_shader2())
    w.add_file(SHADER_PACKAGE_PATH, d("rShaderPackage"), 0, build_shader_package())
    w.add_file(MODEL_PATH, d("rModel"), 0, build_model())
    w.add_file(MODEL_PATH, d("rMaterial"), 0, build_material())
    w.add_file("model\\fixture_cube_skinned", d("rModel"),
               0, build_model(skinned=True))
    w.add_file("model\\fixture_cube_skinned", d("rMaterial"),
               0, build_material())
    w.add_file(TEXTURE_PATH, d("rTexture"), 0, build_texture_rgba())
    w.add_file(CHARACTER_PATH, d("nGO::rCharacter"), 0, build_character_prp())
    return w.tobytes()


def write_fixture_tree(root) -> None:
    """Materialise the fixture set as loose files + the packed archive."""
    from pathlib import Path

    root = Path(root)
    d = dti_mod.from_name

    def put(path: str, dti_name: str, data: bytes):
        ext = d(dti_name).file_ext
        p = root / (path.replace("\\", "/") + "." + ext)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)

    put(SHADER_PACKAGE_PATH, "rShader2", build_shader2())
    put(SHADER_PACKAGE_PATH, "rShaderPackage", build_shader_package())
    put(MODEL_PATH, "rModel", build_model())
    put("model/fixture_cube_skinned", "rModel", build_model(skinned=True))
    put("model/fixture_cube_skinned", "rMaterial", build_material())
    put(MODEL_PATH, "rMaterial", build_material())
    put(TEXTURE_PATH, "rTexture", build_texture_rgba())
    put("model/fixture_albedo_bc1", "rTexture", build_texture_bc1())
    put("model/fixture_albedo_bc7", "rTexture", build_texture_bc7())
    put("motion/fixture_bones", "rScheduler", build_scheduler_bones())
    put("model/fixture_cube_rich", "rModel", build_model_rich())
    put("model/fixture_cube_rich", "rMaterial", build_material())
    put("chara/fixture_character_skinned", "nGO::rCharacter",
        build_character_prp(model_path="model\\fixture_cube_skinned"))
    put(CHARACTER_PATH, "nGO::rCharacter", build_character_prp())
    put("gui/fixture_messages", "rGUIMessage", build_gmd())
    put("motion/fixture_timeline", "rScheduler", build_scheduler())
    (root / "fixture_scene.arc").write_bytes(build_archive())
