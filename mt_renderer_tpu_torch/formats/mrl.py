"""rMaterial (.mrl) — per-model material table.

Layout (reference ``src/rmaterial.rs``):

* 0x28 header: magic ``"MRL\\0"``, version, material/texture counts, shader
  version, texture-table and material-table offsets (``rmaterial.rs:12-24``).
* 0x98 texture records: DTI hash + two runtime pointers + 128-byte path
  (``rmaterial.rs:26-54``).
* 0x48 material records: DTI hash, name CRC, state buffer size,
  blend/depth/raster state SO_HANDLEs, state count bitfield, blend factor,
  state-list and animation-list offsets (``rmaterial.rs:96-149``).
* 0x18 state records: bitfield (type:4 group:16 index:12), SHADER_STATE
  value + object-handle CRC pair (``rmaterial.rs:67-94``).

Every state handle resolves against a parsed ``Shader2File``.  Texture
states carry a 1-based index into the texture table; the albedo map is the
state whose shader object is named ``"tAlbedoMap"`` (``rmaterial.rs:267-281``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from .. import dti as dti_mod
from ..dti import DTI
from ..utils import Reader, crc32, cstr, get_logger, parse_error

log = get_logger("formats.mrl")
from .mfx import Shader2File, object_handle

MRL_MAGIC = b"MRL\0"

HEADER_DTYPE = np.dtype([
    ("magic", "S4"),
    ("version", "<u4"),
    ("material_num", "<u4"),
    ("texture_num", "<u4"),
    ("shader_version", "<u4"),
    ("_padding1", "<u4"),
    ("textures", "<u8"),
    ("materials", "<u8"),
])

TEXTURE_INFO_DTYPE = np.dtype([
    ("dti_hash", "<u4"),
    ("_padding", "<u4"),
    ("_ptex", "<u8"),
    ("_plut", "<u8"),
    ("path", "S128"),
])

MATERIAL_STATE_DTYPE = np.dtype([
    ("bitfield_0x0", "<u4"),
    ("_padding", "<u4"),
    ("sh_value", "<u8"),
    ("sh_crc", "<u4"),
    ("_padding1", "<u4"),
])

MATERIAL_INFO_DTYPE = np.dtype([
    ("dti_hash", "<u4"),
    ("_padding", "<u4"),
    ("name_hash", "<u4"),
    ("state_bufsize", "<u4"),
    ("bsstate", "<u4"),
    ("dsstate", "<u4"),
    ("rsstate", "<u4"),
    ("bitfield_0x1c", "<u4"),
    ("bitfield_0x20", "<u4"),
    ("blend_factor", "<f4", (4,)),
    ("animation_bufsize", "<u4"),
    ("states", "<u8"),
    ("animation_list", "<u8"),
])


class MaterialStateType(enum.IntEnum):
    STATE_FUNCTION = 0
    STATE_CBUFFER = 1
    STATE_SAMPLER = 2
    STATE_TEXTURE = 3
    STATE_PROCEDURAL = 4


@dataclass
class MaterialState:
    state_type: MaterialStateType
    group: int
    index: int
    sh_value: int
    object_name: str  # the shader object this state targets
    value_name: str | None = None  # resolved object for FUNCTION/SAMPLER values


@dataclass
class MaterialInfo:
    name_hash: int
    mat_type: DTI
    blend_state: str
    depth_state: str
    raster_state: str
    blend_factor: tuple[float, float, float, float]
    states: list[MaterialState] = field(default_factory=list)
    albedo_texture_idx: int | None = None
    # every texture state: shader-object name -> 0-based texture table index
    texture_bindings: dict[str, int] = field(default_factory=dict)


class MaterialFile:
    def __init__(self, src, shader2: Shader2File):
        r = Reader(src)
        data = r.data
        h = r.struct(HEADER_DTYPE)
        if bytes(h["magic"]) != MRL_MAGIC.rstrip(b"\0"):
            raise parse_error(f"bad material magic {bytes(h['magic'])!r}", r.data, 0)

        tex_raw = np.frombuffer(
            data, TEXTURE_INFO_DTYPE, int(h["texture_num"]),
            offset=int(h["textures"]),
        )
        self.textures: list[str] = []
        for t in tex_raw:
            dti = dti_mod.from_hash(int(t["dti_hash"])) if int(t["dti_hash"]) else None
            if dti is not None and dti.name != "rTexture":
                raise ValueError(f"unexpected texture DTI {dti.name}")
            self.textures.append(cstr(t["path"]))

        def obj_name(handle: int) -> str:
            obj = shader2.get_object_by_handle(handle)
            return obj.name if obj else f"<unknown:{handle:08x}>"

        mat_raw = np.frombuffer(
            data, MATERIAL_INFO_DTYPE, int(h["material_num"]),
            offset=int(h["materials"]),
        )
        self.materials: list[MaterialInfo] = []
        for m in mat_raw:
            dti = dti_mod.from_hash(int(m["dti_hash"]))
            if dti is None:
                raise ValueError(f"invalid material DTI 0x{int(m['dti_hash']):08x}")
            info = MaterialInfo(
                name_hash=int(m["name_hash"]),
                mat_type=dti,
                blend_state=obj_name(int(m["bsstate"])),
                depth_state=obj_name(int(m["dsstate"])),
                raster_state=obj_name(int(m["rsstate"])),
                blend_factor=tuple(float(x) for x in m["blend_factor"]),
            )
            state_num = int(m["bitfield_0x1c"]) & 0xFFF
            states = np.frombuffer(
                data, MATERIAL_STATE_DTYPE, state_num, offset=int(m["states"])
            )
            for s in states:
                bf = int(s["bitfield_0x0"])
                stype = MaterialStateType(bf & 0xF)
                sh_value = int(s["sh_value"])
                target = obj_name(int(s["sh_crc"]))
                value_name = None
                if stype in (MaterialStateType.STATE_FUNCTION,
                             MaterialStateType.STATE_SAMPLER):
                    value_name = obj_name(sh_value & 0xFFFFFFFF)
                elif stype == MaterialStateType.STATE_TEXTURE and sh_value != 0:
                    # texture indices are 1-based (rmaterial.rs:267-281)
                    idx = sh_value - 1
                    info.texture_bindings[target] = idx
                    if target == "tAlbedoMap":
                        info.albedo_texture_idx = idx
                info.states.append(MaterialState(
                    state_type=stype,
                    group=(bf >> 4) & 0xFFFF,
                    index=(bf >> 20) & 0xFFF,
                    sh_value=sh_value,
                    object_name=target,
                    value_name=value_name,
                ))
            self.materials.append(info)

    def material_by_name(self, name: str) -> MaterialInfo | None:
        h = crc32(name)
        for m in self.materials:
            if m.name_hash == h:
                return m
        return None


def write_material(
    textures: list[str],
    materials: list[dict],
    version: int = 0x22,
    shader_version: int = 0,
) -> bytes:
    """Build a .mrl byte stream.

    ``materials``: dicts with keys ``name`` (str), ``mat_type`` (DTI name),
    ``blend_state``/``depth_state``/``raster_state`` (shader object names),
    ``texture_states``: list of (shader_object_name, 0-based texture index).
    """
    header_size = HEADER_DTYPE.itemsize
    tex_ofs = header_size
    tex_arr = np.zeros(len(textures), dtype=TEXTURE_INFO_DTYPE)
    rtex = dti_mod.from_name("rTexture")
    for i, path in enumerate(textures):
        tex_arr[i]["dti_hash"] = rtex.hash
        tex_arr[i]["path"] = path.replace("/", "\\").encode()

    mat_ofs = tex_ofs + tex_arr.nbytes
    mat_arr = np.zeros(len(materials), dtype=MATERIAL_INFO_DTYPE)
    state_blobs = []
    state_ofs = mat_ofs + mat_arr.nbytes
    pos = state_ofs
    for i, m in enumerate(materials):
        mtype = dti_mod.from_name(m.get("mat_type", "nDraw::MaterialStd"))
        states = []
        for obj_name_, tex_idx in m.get("texture_states", []):
            s = np.zeros(1, dtype=MATERIAL_STATE_DTYPE)
            s[0]["bitfield_0x0"] = int(MaterialStateType.STATE_TEXTURE)
            s[0]["sh_value"] = tex_idx + 1  # 1-based
            s[0]["sh_crc"] = object_handle(obj_name_)
            states.append(s.tobytes())
        blob = b"".join(states)
        mat_arr[i]["dti_hash"] = mtype.hash
        mat_arr[i]["name_hash"] = crc32(m["name"])
        mat_arr[i]["state_bufsize"] = len(blob)
        mat_arr[i]["bsstate"] = object_handle(m.get("blend_state", "BSSolid"))
        mat_arr[i]["dsstate"] = object_handle(m.get("depth_state", "DSZTestWriteLEq"))
        mat_arr[i]["rsstate"] = object_handle(m.get("raster_state", "RSMeshCN"))
        mat_arr[i]["bitfield_0x1c"] = len(m.get("texture_states", [])) & 0xFFF
        mat_arr[i]["blend_factor"] = (1.0, 1.0, 1.0, 1.0)
        mat_arr[i]["states"] = pos if blob else 0
        state_blobs.append(blob)
        pos += len(blob)

    h = np.zeros(1, dtype=HEADER_DTYPE)
    h[0]["magic"] = MRL_MAGIC
    h[0]["version"] = version
    h[0]["material_num"] = len(materials)
    h[0]["texture_num"] = len(textures)
    h[0]["shader_version"] = shader_version
    h[0]["textures"] = tex_ofs
    h[0]["materials"] = mat_ofs
    return h.tobytes() + tex_arr.tobytes() + mat_arr.tobytes() + b"".join(state_blobs)
