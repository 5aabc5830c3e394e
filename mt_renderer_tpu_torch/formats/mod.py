"""rModel (.mod) — engine model: geometry, materials, joints, parts.

Layout (reference ``src/rmodel.rs``):

* 0xa0-byte header (``rmodel.rs:92-117``): magic ``"MOD\\0"``, u16 version,
  counts (joints/primitives/materials/vertices/indices/polygons), vertex
  buffer size, 7 absolute section offsets, bounding sphere/box, model info.
* immediately after the header: u32 ``boundary_num`` (``rmodel.rs:311``).
* material name table at ``material_info``: 128-byte C strings.
* ``PrimitiveInfo`` records (0x38 bytes, heavily bit-packed,
  ``rmodel.rs:135-171``) at ``primitive_info``; boundaries (0x90) follow
  directly after the primitive array.
* joints at ``joint_info``: ``jnt_num`` × 24-byte JointInfo, then local
  matrices, then inverse-bind matrices (64-byte row-major 4x4 each), then a
  0x100-byte joint remap table.
* parts (0x20) at ``parts_info``; raw vertex bytes at ``vertex_data``
  (``vertexbuf_size``); u16 indices at ``index_data`` (``index_num``).

Primitive topology: only TriangleStrip (= 4) appears in the data
(``rmodel.rs:119-131``); strips use u16 indices with 0xffff restart.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import Reader, cstr, get_logger, parse_error

log = get_logger("formats.mod")

MOD_MAGIC = b"MOD\0"

VEC3_PAD_DTYPE = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("pad", "<f4")])
FLOAT3_DTYPE = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
SPHERE_DTYPE = np.dtype([("pos", FLOAT3_DTYPE), ("r", "<f4")])
AABB_DTYPE = np.dtype([("minpos", VEC3_PAD_DTYPE), ("maxpos", VEC3_PAD_DTYPE)])
MATRIX_DTYPE = np.dtype(("<f4", (4, 4)))  # 64 bytes, row-major rows of vec4
OBB_DTYPE = np.dtype([("coord", MATRIX_DTYPE), ("extent", VEC3_PAD_DTYPE)])

MODEL_INFO_DTYPE = np.dtype([
    ("middist", "<i4"), ("lowdist", "<i4"), ("light_group", "<u4"),
    ("memory", "<u2"), ("reserved", "<u2"),
])

MODEL_HDR_DTYPE = np.dtype([
    ("magic", "S4"),
    ("version", "<u2"),
    ("jnt_num", "<u2"),
    ("primitive_num", "<u2"),
    ("material_num", "<u2"),
    ("vertex_num", "<u4"),
    ("index_num", "<u4"),
    ("polygon_num", "<u4"),
    ("vertexbuf_size", "<u4"),
    ("texture_num", "<u4"),
    ("parts_num", "<u4"),
    ("padding1", "<u4"),
    ("joint_info", "<u8"),
    ("parts_info", "<u8"),
    ("material_info", "<u8"),
    ("primitive_info", "<u8"),
    ("vertex_data", "<u8"),
    ("index_data", "<u8"),
    ("rcn_data", "<u8"),
    ("bounding_sphere", SPHERE_DTYPE),
    ("bounding_box", AABB_DTYPE),
    ("modelinfo", MODEL_INFO_DTYPE),
])

PRIMITIVE_INFO_DTYPE = np.dtype([
    ("drawmode_vertexnum", "<u4"),      # draw_mode:16, vertex_num:16
    ("parts_material_lod", "<u4"),      # parts_no:12, material_no:12, lod:8
    ("very_large_bitfield", "<u4"),     # disp:1 shape:1 sort:1 weight_num:5
                                        # alphapri:8 vertex_stride:8
                                        # topology:6 binormal_flip:1 bridge:1
    ("vertex_ofs", "<u4"),
    ("vertex_base", "<u4"),
    ("inputlayout", "<u4"),             # SO_HANDLE into rShader2
    ("index_ofs", "<u4"),
    ("index_num", "<u4"),
    ("index_base", "<u4"),
    ("envelope_boundary_connect", "<u4"),  # envelope:8 boundary_num:8 connect:16
    ("min_max_index", "<u4"),
    ("padding_", "<u4"),
    ("boundary", "<u8"),
])

PARTS_INFO_DTYPE = np.dtype([
    ("no", "<u4"), ("reserved", "<u4", (3,)), ("boundary", SPHERE_DTYPE),
])

BOUNDARY_INFO_DTYPE = np.dtype([
    ("joint", "<u4"), ("reserved", "<u4", (3,)),
    ("sphere", SPHERE_DTYPE), ("aabb", AABB_DTYPE), ("obb", OBB_DTYPE),
])

JOINT_INFO_DTYPE = np.dtype([
    ("bitfield_0x0", "<u4"),  # no:8, parent:8, symmetry:8
    ("radius", "<f4"), ("length", "<f4"), ("offset", FLOAT3_DTYPE),
])

TOPOLOGY_TRIANGLE_STRIP = 4
STRIP_RESTART = 0xFFFF


@dataclass
class Primitive:
    """Decoded PrimitiveInfo bitfields (rmodel.rs:173-225)."""
    draw_mode: int
    vertex_num: int
    parts_no: int
    material_no: int
    lod: int
    weight_num: int
    alphapri: int
    vertex_stride: int
    topology: int
    vertex_ofs: int
    vertex_base: int
    inputlayout: int
    index_ofs: int
    index_num: int
    index_base: int
    envelope: int
    boundary_num: int
    connect_id: int
    min_index: int
    max_index: int
    disp: bool
    shape: bool
    sort: bool
    binormal_flip: bool
    bridge: bool

    @classmethod
    def from_raw(cls, rec) -> "Primitive":
        dv = int(rec["drawmode_vertexnum"])
        pml = int(rec["parts_material_lod"])
        big = int(rec["very_large_bitfield"])
        ebc = int(rec["envelope_boundary_connect"])
        mmi = int(rec["min_max_index"])
        return cls(
            draw_mode=dv & 0xFFFF,
            vertex_num=(dv >> 16) & 0xFFFF,
            parts_no=pml & 0xFFF,
            material_no=(pml >> 12) & 0xFFF,
            lod=(pml >> 24) & 0xFF,
            disp=bool(big & 1),
            shape=bool((big >> 1) & 1),
            sort=bool((big >> 2) & 1),
            weight_num=(big >> 3) & 0x1F,
            alphapri=(big >> 8) & 0xFF,
            vertex_stride=(big >> 16) & 0xFF,
            topology=(big >> 24) & 0x3F,
            binormal_flip=bool((big >> 30) & 1),
            bridge=bool((big >> 31) & 1),
            vertex_ofs=int(rec["vertex_ofs"]),
            vertex_base=int(rec["vertex_base"]),
            inputlayout=int(rec["inputlayout"]),
            index_ofs=int(rec["index_ofs"]),
            index_num=int(rec["index_num"]),
            index_base=int(rec["index_base"]),
            envelope=ebc & 0xFF,
            boundary_num=(ebc >> 8) & 0xFF,
            connect_id=(ebc >> 16) & 0xFFFF,
            min_index=mmi & 0xFFFF,
            max_index=(mmi >> 16) & 0xFFFF,
        )

    def pack_raw(self) -> np.ndarray:
        rec = np.zeros(1, dtype=PRIMITIVE_INFO_DTYPE)[0]
        rec["drawmode_vertexnum"] = (self.draw_mode & 0xFFFF) | (self.vertex_num << 16)
        rec["parts_material_lod"] = (
            (self.parts_no & 0xFFF) | ((self.material_no & 0xFFF) << 12)
            | ((self.lod & 0xFF) << 24)
        )
        rec["very_large_bitfield"] = (
            int(self.disp) | (int(self.shape) << 1) | (int(self.sort) << 2)
            | ((self.weight_num & 0x1F) << 3) | ((self.alphapri & 0xFF) << 8)
            | ((self.vertex_stride & 0xFF) << 16) | ((self.topology & 0x3F) << 24)
            | (int(self.binormal_flip) << 30) | (int(self.bridge) << 31)
        )
        rec["vertex_ofs"] = self.vertex_ofs
        rec["vertex_base"] = self.vertex_base
        rec["inputlayout"] = self.inputlayout
        rec["index_ofs"] = self.index_ofs
        rec["index_num"] = self.index_num
        rec["index_base"] = self.index_base
        rec["envelope_boundary_connect"] = (
            (self.envelope & 0xFF) | ((self.boundary_num & 0xFF) << 8)
            | ((self.connect_id & 0xFFFF) << 16)
        )
        rec["min_max_index"] = (self.min_index & 0xFFFF) | (self.max_index << 16)
        return rec


@dataclass
class Joint:
    no: int
    parent: int
    symmetry: int
    radius: float
    length: float
    offset: np.ndarray  # (3,) float32


class ModelFile:
    def __init__(self, src):
        r = Reader(src)
        h = r.struct(MODEL_HDR_DTYPE)
        if bytes(h["magic"]) != MOD_MAGIC.rstrip(b"\0"):
            raise parse_error(f"bad model magic {bytes(h['magic'])!r}", r.data, 0)
        log.debug(
            "model: v%d, %d materials, %d primitives, %d joints, %d parts, "
            "%d verts / %d indices", int(h["version"]), int(h["material_num"]),
            int(h["primitive_num"]), int(h["jnt_num"]), int(h["parts_num"]),
            int(h["vertex_num"]), int(h["index_num"]),
        )
        self.header = h
        self.version = int(h["version"])
        boundary_num = int(r.struct(np.dtype("<u4")))

        mat_num = int(h["material_num"])
        r.seek(int(h["material_info"]))
        mat_bytes = r.read(mat_num * 128)
        self.material_names = [
            cstr(mat_bytes[i * 128:(i + 1) * 128]) for i in range(mat_num)
        ]

        r.seek(int(h["primitive_info"]))
        raw_prims = r.struct_array(PRIMITIVE_INFO_DTYPE, int(h["primitive_num"]))
        self.primitives = [Primitive.from_raw(p) for p in raw_prims]
        for i, p in enumerate(self.primitives):
            log.debug("  prim[%d]: mat=%d parts=%d stride=%d weights=%d "
                      "verts=%d idx=%d+%d", i, p.material_no, p.parts_no,
                      p.vertex_stride, p.weight_num, p.vertex_num,
                      p.index_ofs, p.index_num)

        # boundaries follow the primitive array directly (rmodel.rs:358-366)
        self.boundaries = r.struct_array(BOUNDARY_INFO_DTYPE, boundary_num).copy()

        jnt_num = int(h["jnt_num"])
        r.seek(int(h["joint_info"]))
        if jnt_num:
            raw_joints = r.struct_array(JOINT_INFO_DTYPE, jnt_num)
            self.joints = [
                Joint(
                    no=int(j["bitfield_0x0"]) & 0xFF,
                    parent=(int(j["bitfield_0x0"]) >> 8) & 0xFF,
                    symmetry=(int(j["bitfield_0x0"]) >> 16) & 0xFF,
                    radius=float(j["radius"]),
                    length=float(j["length"]),
                    offset=np.array(
                        [j["offset"]["x"], j["offset"]["y"], j["offset"]["z"]],
                        dtype=np.float32,
                    ),
                )
                for j in raw_joints
            ]
            self.local_mats = r.struct_array(MATRIX_DTYPE, jnt_num).copy()
            self.inverse_bind_mats = r.struct_array(MATRIX_DTYPE, jnt_num).copy()
            self.joint_table = np.frombuffer(r.read(0x100), dtype=np.uint8).copy()
        else:
            self.joints = []
            self.local_mats = np.zeros((0, 4, 4), dtype=np.float32)
            self.inverse_bind_mats = np.zeros((0, 4, 4), dtype=np.float32)
            self.joint_table = np.full(0x100, 255, dtype=np.uint8)

        r.seek(int(h["parts_info"]))
        self.parts = r.struct_array(PARTS_INFO_DTYPE, int(h["parts_num"])).copy()

        r.seek(int(h["vertex_data"]))
        self.vertex_buf = np.frombuffer(
            r.read(int(h["vertexbuf_size"])), dtype=np.uint8
        ).copy()

        r.seek(int(h["index_data"]))
        self.index_buf = np.frombuffer(
            r.read(int(h["index_num"]) * 2), dtype="<u2"
        ).copy()


def write_model(
    material_names: list[str],
    primitives: list[Primitive],
    vertex_buf: bytes,
    index_buf: np.ndarray,
    joints: list[Joint] | None = None,
    local_mats: np.ndarray | None = None,
    inverse_bind_mats: np.ndarray | None = None,
    boundaries: np.ndarray | None = None,
    parts_num: int = 1,
    version: int = 0xD2,
) -> bytes:
    """Serialize a model byte stream (synthetic fixtures + tooling)."""
    joints = joints or []
    jnt_num = len(joints)
    index_buf = np.asarray(index_buf, dtype="<u2")
    if boundaries is None:
        boundaries = np.zeros(1, dtype=BOUNDARY_INFO_DTYPE)
    boundary_num = len(boundaries)

    pos = MODEL_HDR_DTYPE.itemsize + 4  # header + boundary_num u32

    def align(p, a=16):
        return (p + a - 1) & ~(a - 1)

    joint_info_ofs = align(pos)
    joint_bytes = b""
    if jnt_num:
        jarr = np.zeros(jnt_num, dtype=JOINT_INFO_DTYPE)
        for i, j in enumerate(joints):
            jarr[i]["bitfield_0x0"] = (
                (j.no & 0xFF) | ((j.parent & 0xFF) << 8) | ((j.symmetry & 0xFF) << 16)
            )
            jarr[i]["radius"] = j.radius
            jarr[i]["length"] = j.length
            jarr[i]["offset"]["x"], jarr[i]["offset"]["y"], jarr[i]["offset"]["z"] = (
                j.offset
            )
        lmats = (local_mats if local_mats is not None
                 else np.tile(np.eye(4, dtype="<f4"), (jnt_num, 1, 1)))
        imats = (inverse_bind_mats if inverse_bind_mats is not None
                 else np.tile(np.eye(4, dtype="<f4"), (jnt_num, 1, 1)))
        jtable = np.arange(0x100, dtype=np.uint8)
        joint_bytes = (
            jarr.tobytes()
            + np.ascontiguousarray(lmats, dtype="<f4").tobytes()
            + np.ascontiguousarray(imats, dtype="<f4").tobytes()
            + jtable.tobytes()
        )
    pos = joint_info_ofs + len(joint_bytes)

    material_info_ofs = align(pos)
    mat_bytes = b"".join(
        name.encode()[:127].ljust(128, b"\0") for name in material_names
    )
    pos = material_info_ofs + len(mat_bytes)

    primitive_info_ofs = align(pos)
    prim_arr = np.zeros(len(primitives), dtype=PRIMITIVE_INFO_DTYPE)
    for i, p in enumerate(primitives):
        prim_arr[i] = p.pack_raw()
    prim_bytes = prim_arr.tobytes() + boundaries.tobytes()
    pos = primitive_info_ofs + len(prim_bytes)

    parts_info_ofs = align(pos)
    parts = np.zeros(parts_num, dtype=PARTS_INFO_DTYPE)
    parts["no"] = np.arange(parts_num)
    pos = parts_info_ofs + parts.nbytes

    vertex_data_ofs = align(pos)
    pos = vertex_data_ofs + len(vertex_buf)
    index_data_ofs = align(pos)
    pos = index_data_ofs + index_buf.nbytes

    h = np.zeros(1, dtype=MODEL_HDR_DTYPE)
    h[0]["magic"] = MOD_MAGIC
    h[0]["version"] = version
    h[0]["jnt_num"] = jnt_num
    h[0]["primitive_num"] = len(primitives)
    h[0]["material_num"] = len(material_names)
    h[0]["vertex_num"] = sum(p.vertex_num for p in primitives)
    h[0]["index_num"] = len(index_buf)
    h[0]["polygon_num"] = sum(max(0, p.index_num - 2) for p in primitives)
    h[0]["vertexbuf_size"] = len(vertex_buf)
    h[0]["parts_num"] = parts_num
    h[0]["joint_info"] = joint_info_ofs
    h[0]["parts_info"] = parts_info_ofs
    h[0]["material_info"] = material_info_ofs
    h[0]["primitive_info"] = primitive_info_ofs
    h[0]["vertex_data"] = vertex_data_ofs
    h[0]["index_data"] = index_data_ofs

    out = bytearray(pos)
    cur = 0
    out[cur:cur + h.nbytes] = h.tobytes(); cur += h.nbytes
    out[cur:cur + 4] = np.uint32(boundary_num).tobytes(); cur += 4
    out[joint_info_ofs:joint_info_ofs + len(joint_bytes)] = joint_bytes
    out[material_info_ofs:material_info_ofs + len(mat_bytes)] = mat_bytes
    out[primitive_info_ofs:primitive_info_ofs + len(prim_bytes)] = prim_bytes
    out[parts_info_ofs:parts_info_ofs + parts.nbytes] = parts.tobytes()
    out[vertex_data_ofs:vertex_data_ofs + len(vertex_buf)] = vertex_buf
    out[index_data_ofs:index_data_ofs + index_buf.nbytes] = index_buf.tobytes()
    return bytes(out)
