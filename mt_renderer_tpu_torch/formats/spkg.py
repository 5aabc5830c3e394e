"""rShaderPackage — compiled shader bytecode package.

Layout (reference ``src/rshaderpackage.rs``):

* 0x30 header: magic, shader version, per-stage shader counts
  (vs/ps/gs/hs/ds/cs), input layout count, body length/offset
  (``rshaderpackage.rs:15-36``).
* CORE block from 0x30 to ``body_offset``: list offsets (relative to CORE)
  for each stage + input-layout list + a 0x1000-entry pointer table, then a
  VLA of 0x70 shader records (``rshaderpackage.rs:39-54``).
* code info records (0x10): bitfield (code size = bits 10+), crc, body
  offset of the raw compiled bytecode blob (``rshaderpackage.rs:127-149``).
* input records (0x20): 4 SO_HANDLEs cross-referenced into rShader2 + crc
  (``rshaderpackage.rs:151-168``).

The renderer never executes this DXBC (shading is reimplemented as
device functions), but extraction/inspection parity is kept for the
``shaderpackagedump`` tool.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import Reader
from .mfx import Shader2File, Shader2Object

HEADER_DTYPE = np.dtype([
    ("magic", "<u4"),
    ("shader_version", "<u4"),
    ("version", "<u2"),
    ("num_shaders", "<u2"),
    ("num_vertexshaders", "<u2"),
    ("num_pixelshaders", "<u2"),
    ("num_geometryshaders", "<u2"),
    ("num_hullshaders", "<u2"),
    ("num_domainshaders", "<u2"),
    ("num_computeshaders", "<u2"),
    ("num_inputlayouts", "<u2"),
    ("field_1a", "<u2"),
    ("field_1c", "<u4"),
    ("field_20", "<u4"),
    ("body_length", "<u4"),
    ("body_offset", "<u8"),
])

CORE_HEAD_DTYPE = np.dtype([
    ("field_0_ptr", "<u8"),
    ("field_8_ptr", "<u8"),
    ("ia_list", "<u8"),
    ("vs_list", "<u8"),
    ("ps_list", "<u8"),
    ("gs_list", "<u8"),
    ("hs_list", "<u8"),
    ("ds_list", "<u8"),
    ("cs_list", "<u8"),
    ("tables", "<u8"),
])
PTABLE_LEN = 0x1000
CORE_SIZE = CORE_HEAD_DTYPE.itemsize + PTABLE_LEN * 8

SHADER_DTYPE = np.dtype([("raw", "V112")])  # 0x70 opaque record

CODE_INFO_DTYPE = np.dtype([
    ("bitfield_0x0", "<u4"),
    ("crc", "<u4"),
    ("pcode", "<u8"),
])

INPUT_DTYPE = np.dtype([
    ("layouts", "<u4", (4,)),
    ("crc", "<u4"),
    ("padding1", "<u4"),
    ("playout", "<u8"),
])


@dataclass
class ShaderCode:
    code: bytes
    crc: int


@dataclass
class ShaderInput:
    layouts: list[Shader2Object | None]
    crc: int


class ShaderPackageFile:
    def __init__(self, src, shader2: Shader2File):
        r = Reader(src)
        h = r.struct(HEADER_DTYPE)
        self.header = h
        core_bytes = r.read(int(h["body_offset"]) - HEADER_DTYPE.itemsize)
        body = r.read(int(h["body_length"]))
        core = np.frombuffer(core_bytes, CORE_HEAD_DTYPE, 1)[0]

        def get_shaders(count: int, offs: int) -> list[ShaderCode]:
            infos = np.frombuffer(core_bytes, CODE_INFO_DTYPE, count, offset=offs)
            out = []
            for info in infos:
                size = int(info["bitfield_0x0"]) >> 10
                code_offs = int(info["pcode"])
                out.append(ShaderCode(
                    code=body[code_offs:code_offs + size], crc=int(info["crc"])
                ))
            return out

        self.vertex_shaders = get_shaders(
            int(h["num_vertexshaders"]), int(core["vs_list"]))
        self.pixel_shaders = get_shaders(
            int(h["num_pixelshaders"]), int(core["ps_list"]))
        self.geometry_shaders = get_shaders(
            int(h["num_geometryshaders"]), int(core["gs_list"]))
        self.hull_shaders = get_shaders(
            int(h["num_hullshaders"]), int(core["hs_list"]))
        self.domain_shaders = get_shaders(
            int(h["num_domainshaders"]), int(core["ds_list"]))
        self.compute_shaders = get_shaders(
            int(h["num_computeshaders"]), int(core["cs_list"]))

        raw_inputs = np.frombuffer(
            core_bytes, INPUT_DTYPE, int(h["num_inputlayouts"]),
            offset=int(core["ia_list"]),
        )
        self.inputs = [
            ShaderInput(
                layouts=[shader2.get_object_by_handle(int(x)) for x in ia["layouts"]],
                crc=int(ia["crc"]),
            )
            for ia in raw_inputs
        ]

        # raw 0x70 records (VLA after CORE)
        self.shader_records = np.frombuffer(
            core_bytes, SHADER_DTYPE, int(h["num_shaders"]), offset=CORE_SIZE
        )


def write_shader_package(
    inputs: list[tuple[list[int], int]],
    stage_shaders: dict[str, list[tuple[bytes, int]]] | None = None,
    shader_version: int = 0,
) -> bytes:
    """Build a shader package byte stream (fixtures/tooling).

    ``inputs``: (four SO_HANDLEs, crc) per input layout.
    ``stage_shaders``: stage key ('vs','ps','gs','hs','ds','cs') →
    list of (bytecode, crc).
    """
    stage_shaders = stage_shaders or {}
    stages = ["vs", "ps", "gs", "hs", "ds", "cs"]

    core = bytearray(CORE_SIZE)
    body = bytearray()
    list_offsets = {}

    core_tail = bytearray()

    def core_pos():
        return CORE_SIZE + len(core_tail)

    # shader VLA would follow CORE; we emit none (num_shaders=0), then lists
    for stage in stages:
        entries = stage_shaders.get(stage, [])
        list_offsets[stage] = core_pos()
        arr = np.zeros(len(entries), dtype=CODE_INFO_DTYPE)
        for i, (code, crc) in enumerate(entries):
            arr[i]["bitfield_0x0"] = len(code) << 10
            arr[i]["crc"] = crc
            arr[i]["pcode"] = len(body)
            body += code
        core_tail += arr.tobytes()

    ia_ofs = core_pos()
    ia_arr = np.zeros(len(inputs), dtype=INPUT_DTYPE)
    for i, (layouts, crc) in enumerate(inputs):
        ia_arr[i]["layouts"] = layouts
        ia_arr[i]["crc"] = crc
    core_tail += ia_arr.tobytes()

    core_head = np.zeros(1, dtype=CORE_HEAD_DTYPE)
    core_head[0]["ia_list"] = ia_ofs
    for stage in stages:
        core_head[0][f"{stage}_list"] = list_offsets[stage]
    core[:CORE_HEAD_DTYPE.itemsize] = core_head.tobytes()

    h = np.zeros(1, dtype=HEADER_DTYPE)
    h[0]["magic"] = int.from_bytes(b"SPC\0", "little")
    h[0]["shader_version"] = shader_version
    h[0]["num_shaders"] = 0
    for stage in stages:
        key = {
            "vs": "num_vertexshaders", "ps": "num_pixelshaders",
            "gs": "num_geometryshaders", "hs": "num_hullshaders",
            "ds": "num_domainshaders", "cs": "num_computeshaders",
        }[stage]
        h[0][key] = len(stage_shaders.get(stage, []))
    h[0]["num_inputlayouts"] = len(inputs)
    h[0]["body_length"] = len(body)
    h[0]["body_offset"] = HEADER_DTYPE.itemsize + len(core) + len(core_tail)
    return h.tobytes() + bytes(core) + bytes(core_tail) + bytes(body)
