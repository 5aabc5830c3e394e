"""rShader2 (.mfx) — shader metadata: objects, cbuffers, input layouts.

Layout (reference ``src/rshader2.rs``):

* 0x20 header: magic ``"MFX\\0"`` (= 0x58464d LE), major/minor u16s, shader
  version u32, ``num_objects`` u32, string-table offset u64, then the object
  pointer array begins (indexing starts at 1, so ``num_objects - 1`` pointers
  are stored — ``rshader2.rs:22-28,314-324``).
* each object: 0x28 record — name/sname string-table offsets, bitfield
  (``obj_type`` low 6 bits, annotation count in bits 22+), bitfield
  (sindex:16 / index:16), hash, annotation pointer — followed by a
  type-specific payload for CBUFFER / STRUCT / INPUTLAYOUT.
* input layout elements are 0x10 records whose u32 bitfield packs
  sindex:6 format:5 count:7 start:4 offset:9 instance:1
  (``rshader2.rs:425-430``).
* objects are addressed by 20-bit name-CRC *handles*:
  ``(handle & 0xfffff000) >> 12`` (``rshader2.rs:489-494``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from ..utils import Reader, crc32, get_logger, parse_error, read_cstring

log = get_logger("formats.mfx")

MFX_MAGIC = 0x58464D  # b"MFX\0" read as LE u32

HEADER_DTYPE = np.dtype([
    ("magic", "<u4"),
    ("major_version", "<u2"),
    ("minor_version", "<u2"),
    ("shader_version", "<u4"),
    ("num_objects", "<u4"),
    ("stringtable_offs", "<u8"),
    ("pbojects", "<u8"),
])

OBJECT_DTYPE = np.dtype([
    ("name_offs", "<u8"),
    ("sname_offs", "<u8"),
    ("bitfield_0x10", "<u4"),
    ("bitfield_0x14", "<u4"),
    ("hash", "<u4"),
    ("padding1", "<u4"),
    ("annotations", "<u8"),
])

INPUT_ELEMENT_DTYPE = np.dtype([
    ("name", "<u8"),
    ("bitfield", "<u4"),
    ("padding1", "<u4"),
])

INPUTLAYOUT_DTYPE = np.dtype([
    ("bitfield_0", "<u4"),
    ("padding1", "<u4"),
    ("pdefaultvalues", "<u8"),
])

STRUCT_DTYPE = np.dtype([
    ("bitfield_0", "<u4"),
    ("padding1", "<u4"),
    ("members", "<u8"),
])

CBUFFER_DTYPE = np.dtype([
    ("bitfield_0", "<u4"),
    ("crc", "<u4"),
    ("variables", "<u8"),
    ("pinitvalues", "<u8"),
])

VARIABLE_DTYPE = np.dtype([
    ("name", "<u8"),
    ("bitfield_0x8", "<u4"),
    ("field_4", "<u4"),
    ("sname", "<u8"),
    ("bitfield_0x18", "<u4"),
    ("padding1", "<u4"),
    ("annotations", "<u8"),
    ("pinitvalues", "<u8"),
])


class ObjectType(enum.IntEnum):
    CBUFFER = 0
    TEXTURE = 1
    FUNCTION = 2
    SAMPLER = 3
    BLEND = 4
    DEPTHSTENCIL = 5
    RASTERIZER = 6
    TECHNIQUE = 7
    STRUCT = 8
    INPUTLAYOUT = 9
    SAMPLERCMP = 10
    POINTSTREAM = 11
    LINESTREAM = 12
    TRIANGLESTREAM = 13
    INPUTPATCH = 14
    OUTPUTPATCH = 15
    UNKNOWN_16 = 16
    UNKNOWN_17 = 17


class InputElementFormat(enum.IntEnum):
    IEF_UNDEFINED = 0
    IEF_F32 = 1
    IEF_F16 = 2
    IEF_S16 = 3
    IEF_U16 = 4
    IEF_S16N = 5
    IEF_U16N = 6
    IEF_S8 = 7
    IEF_U8 = 8
    IEF_S8N = 9
    IEF_U8N = 10
    IEF_SCMP3N = 11
    IEF_UCMP3N = 12
    IEF_U8NL = 13
    IEF_COLOR4N = 14
    IEF_MAX = 15


class ClassType(enum.IntEnum):
    CT_UNDEFINED = 0
    CT_VOID = 1
    CT_SCALAR = 2
    CT_VECTOR = 3
    CT_MATRIX = 4
    CT_STRUCT = 5
    CT_OBJECT = 6


@dataclass
class InputElement:
    name: str
    sindex: int
    format: InputElementFormat
    count: int
    start: int
    offset: int
    instance: int

    def pack_bitfield(self) -> int:
        return (
            (self.sindex & 0x3F)
            | ((int(self.format) & 0x1F) << 6)
            | ((self.count & 0x7F) << 11)
            | ((self.start & 0x0F) << 18)
            | ((self.offset & 0x1FF) << 22)
            | ((self.instance & 1) << 31)
        )


@dataclass
class Variable:
    name: str
    sname: str
    ctype: ClassType
    size: int
    sindex: int
    offset: int
    annotations: list["Variable"] | None = None


@dataclass
class InputLayoutInfo:
    stride: int
    elements: list[InputElement]


@dataclass
class StructInfo:
    variables: list[Variable]


@dataclass
class CBufferInfo:
    crc: int
    variables: list[Variable]


@dataclass
class Shader2Object:
    name: str
    sname: str | None
    obj_type: ObjectType
    name_hash: int
    sindex: int
    index: int
    annotations: list[Variable] | None = None
    specific: object = None


def object_handle(name: str) -> int:
    """Build an SO_HANDLE from an object name (20-bit CRC << 12)."""
    return (crc32(name) & 0xFFFFF) << 12


class Shader2File:
    def __init__(self, src):
        r = Reader(src)
        data = r.data
        h = np.frombuffer(data, HEADER_DTYPE, 1)[0]
        if int(h["magic"]) != MFX_MAGIC:
            raise parse_error(
                f"rShader2 magic incorrect: {int(h['magic']):08x}", data, 0
            )
        st = int(h["stringtable_offs"])

        def name_at(offs: int) -> str:
            return read_cstring(data, st + offs)

        def parse_variables(offs: int, num: int) -> list[Variable]:
            raws = np.frombuffer(data, VARIABLE_DTYPE, num, offset=offs)
            out = []
            for v in raws:
                bf8 = int(v["bitfield_0x8"])
                bf18 = int(v["bitfield_0x18"])
                annotation_num = (bf18 >> 24) & 0xFF
                annotations = (
                    parse_variables(int(v["annotations"]), annotation_num)
                    if int(v["annotations"]) else None
                )
                out.append(Variable(
                    name=name_at(int(v["name"])),
                    sname=name_at(int(v["sname"])),
                    ctype=ClassType((bf8 >> 19) & 0x7),
                    size=(bf8 >> 22) & 0x3FF,
                    sindex=bf18 & 0xFF,
                    offset=(bf18 >> 8) & 0x3FF,
                    annotations=annotations,
                ))
            return out

        num_ptrs = int(h["num_objects"]) - 1
        ptrs = np.frombuffer(data, "<u8", num_ptrs, offset=HEADER_DTYPE.itemsize)

        self.objects: list[Shader2Object] = []
        self._by_hash: dict[int, int] = {}
        for ptr in ptrs.astype(np.int64):
            raw = np.frombuffer(data, OBJECT_DTYPE, 1, offset=int(ptr))[0]
            name = name_at(int(raw["name_offs"]))
            sname = (name_at(int(raw["sname_offs"]))
                     if int(raw["sname_offs"]) else None)
            bf10 = int(raw["bitfield_0x10"])
            bf14 = int(raw["bitfield_0x14"])
            obj_type = ObjectType(bf10 & 0x3F)
            annotation_num = bf10 >> 0x16
            annotations = (
                parse_variables(int(raw["annotations"]), annotation_num)
                if int(raw["annotations"]) else None
            )

            body = int(ptr) + OBJECT_DTYPE.itemsize
            specific = None
            if obj_type == ObjectType.CBUFFER:
                cb = np.frombuffer(data, CBUFFER_DTYPE, 1, offset=body)[0]
                nvars = (int(cb["bitfield_0"]) >> 16) & 0xFFFF
                specific = CBufferInfo(
                    crc=int(cb["crc"]),
                    variables=parse_variables(int(cb["variables"]), nvars),
                )
            elif obj_type == ObjectType.STRUCT:
                s = np.frombuffer(data, STRUCT_DTYPE, 1, offset=body)[0]
                nmem = (int(s["bitfield_0"]) >> 0xA) & 0xFFF
                specific = StructInfo(parse_variables(int(s["members"]), nmem))
            elif obj_type == ObjectType.INPUTLAYOUT:
                il = np.frombuffer(data, INPUTLAYOUT_DTYPE, 1, offset=body)[0]
                count = int(il["bitfield_0"]) & 0xFFFF
                stride = (int(il["bitfield_0"]) >> 16) & 0xFFFF
                raw_elems = np.frombuffer(
                    data, INPUT_ELEMENT_DTYPE, count,
                    offset=body + INPUTLAYOUT_DTYPE.itemsize,
                )
                elements = []
                for e in raw_elems:
                    bf = int(e["bitfield"])
                    elements.append(InputElement(
                        name=name_at(int(e["name"])),
                        sindex=bf & 0x3F,
                        format=InputElementFormat((bf >> 6) & 0x1F),
                        count=(bf >> 11) & 0x7F,
                        start=(bf >> 18) & 0x0F,
                        offset=(bf >> 22) & 0x1FF,
                        instance=(bf >> 31) & 0x1,
                    ))
                specific = InputLayoutInfo(stride=stride, elements=elements)

            name_hash = crc32(name) & 0xFFFFF
            if name_hash in self._by_hash:
                other = self.objects[self._by_hash[name_hash]].name
                raise ValueError(
                    f"shader object name hash collision: {name} and {other}"
                )
            self._by_hash[name_hash] = len(self.objects)
            self.objects.append(Shader2Object(
                name=name, sname=sname, obj_type=obj_type, name_hash=name_hash,
                sindex=bf14 & 0xFFFF, index=(bf14 >> 16) & 0xFFFF,
                annotations=annotations, specific=specific,
            ))

    def get_object_by_handle(self, handle: int) -> Shader2Object | None:
        idx = self._by_hash.get((handle & 0xFFFFF000) >> 12)
        return self.objects[idx] if idx is not None else None

    def get_object_by_name(self, name: str) -> Shader2Object | None:
        return self.get_object_by_handle(object_handle(name))


@dataclass
class _WriterObject:
    name: str
    obj_type: ObjectType
    sname: str | None = None
    sindex: int = 0
    index: int = 0
    inputlayout: InputLayoutInfo | None = None
    cbuffer_vars: list[tuple[str, ClassType, int, int]] = field(default_factory=list)


class Shader2Writer:
    """Builds .mfx byte streams (fixtures, tooling, custom shader sets)."""

    def __init__(self, major: int = 1, minor: int = 0, shader_version: int = 0):
        self._objects: list[_WriterObject] = []
        self._versions = (major, minor, shader_version)

    def add_object(self, name: str, obj_type: ObjectType, **kw) -> None:
        self._objects.append(_WriterObject(name, obj_type, **kw))

    def add_inputlayout(self, name: str, stride: int,
                        elements: list[InputElement]) -> None:
        self._objects.append(_WriterObject(
            name, ObjectType.INPUTLAYOUT,
            inputlayout=InputLayoutInfo(stride, elements),
        ))

    def tobytes(self) -> bytes:
        strings = bytearray(b"\0")  # offset 0 = empty string
        str_offsets: dict[str, int] = {"": 0}

        def intern(s: str) -> int:
            if s not in str_offsets:
                str_offsets[s] = len(strings)
                strings.extend(s.encode("shift_jis") + b"\0")
            return str_offsets[s]

        n = len(self._objects)
        header_size = HEADER_DTYPE.itemsize
        ptr_table_ofs = header_size
        body_ofs = ptr_table_ofs + 8 * n

        obj_blobs: list[bytes] = []
        ptrs: list[int] = []
        pos = body_ofs
        for o in self._objects:
            rec = np.zeros(1, dtype=OBJECT_DTYPE)
            rec[0]["name_offs"] = intern(o.name)
            rec[0]["sname_offs"] = intern(o.sname) if o.sname else 0
            rec[0]["bitfield_0x10"] = int(o.obj_type) & 0x3F
            rec[0]["bitfield_0x14"] = (o.sindex & 0xFFFF) | ((o.index & 0xFFFF) << 16)
            blob = rec.tobytes()
            if o.obj_type == ObjectType.INPUTLAYOUT:
                il = o.inputlayout
                ilrec = np.zeros(1, dtype=INPUTLAYOUT_DTYPE)
                ilrec[0]["bitfield_0"] = (
                    (len(il.elements) & 0xFFFF) | ((il.stride & 0xFFFF) << 16)
                )
                elems = np.zeros(len(il.elements), dtype=INPUT_ELEMENT_DTYPE)
                for i, e in enumerate(il.elements):
                    elems[i]["name"] = intern(e.name)
                    elems[i]["bitfield"] = e.pack_bitfield()
                blob += ilrec.tobytes() + elems.tobytes()
            elif o.obj_type == ObjectType.CBUFFER:
                nvars = len(o.cbuffer_vars)
                cbrec = np.zeros(1, dtype=CBUFFER_DTYPE)
                cbrec[0]["bitfield_0"] = (nvars & 0xFFFF) << 16
                cbrec[0]["crc"] = crc32(o.name)
                var_ofs = pos + OBJECT_DTYPE.itemsize + CBUFFER_DTYPE.itemsize
                cbrec[0]["variables"] = var_ofs if nvars else 0
                vars_arr = np.zeros(nvars, dtype=VARIABLE_DTYPE)
                for i, (vname, ctype, size, offset) in enumerate(o.cbuffer_vars):
                    vars_arr[i]["name"] = intern(vname)
                    vars_arr[i]["sname"] = intern(vname)
                    vars_arr[i]["bitfield_0x8"] = (
                        ((int(ctype) & 0x7) << 19) | ((size & 0x3FF) << 22)
                    )
                    vars_arr[i]["bitfield_0x18"] = (offset & 0x3FF) << 8
                blob += cbrec.tobytes() + vars_arr.tobytes()
            ptrs.append(pos)
            obj_blobs.append(blob)
            pos += len(blob)

        stringtable_ofs = pos
        h = np.zeros(1, dtype=HEADER_DTYPE)
        h[0]["magic"] = MFX_MAGIC
        h[0]["major_version"], h[0]["minor_version"], h[0]["shader_version"] = (
            self._versions
        )
        h[0]["num_objects"] = n + 1  # indices start at 1
        h[0]["stringtable_offs"] = stringtable_ofs
        h[0]["pbojects"] = ptr_table_ofs

        return (
            h.tobytes()
            + np.asarray(ptrs, dtype="<u8").tobytes()
            + b"".join(obj_blobs)
            + bytes(strings)
        )
