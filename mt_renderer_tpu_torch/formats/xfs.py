"""XFS / .prp — the engine's reflection-based object serializer.

Files carry a property *database* (class layouts) followed by the serialized
object graph (reference ``src/mtserializer.rs``):

* 0x18 header: magic ``"XFS\\0"``, major version 16, minor version,
  max object id, object count, database size (``mtserializer.rs:16-28``).
* database: ``object_num`` u64 offsets → per-class records: DTI hash +
  prop count (15-bit) then 0x30 ``RawPropertyInfo`` records — name pointer
  (into the database, SHIFT-JIS), bitfield (type:8 attr:8 size:15
  disabled:1) (``mtserializer.rs:30-52,271-343``).
* object graph: recursive classes. A class starts with a u32 whose bits
  1-15 index the class database (``0xfffe`` low bits → null), then an unused
  u64, then each property as ``u32 count`` + values
  (``mtserializer.rs:202-258``).

Static and dynamic props decode per ``PropType``
(``mtserializer.rs:119-200``).  ``.prp`` files may be wrapped in a 12-byte
``PRPZ`` header (``mtserializer.rs:355-372``).

The reference only deserializes; this module also *serializes* (needed for
synthetic fixtures and tooling).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from .. import dti as dti_mod
from ..dti import DTI, PROP_ATTR_DYNAMIC, PropType
from ..utils import Reader, get_logger, parse_error, read_cstring

log = get_logger("formats.xfs")

XFS_MAGIC = b"XFS\0"
XFS_MAJOR = 16

HEADER_DTYPE = np.dtype([
    ("magic", "S4"),
    ("major_version", "<u2"),
    ("minor_version", "<u2"),
    ("max_object_id", "<u4"),
    ("_reserved", "<u4"),
    ("object_num", "<u4"),
    ("database_size", "<u4"),
])

OBJECT_INFO_DTYPE = np.dtype([
    ("dti_hash", "<u4"),
    ("padding_0x4", "<u4"),
    ("bitfield_0x8", "<u4"),  # prop_num:15, is_init:1
    ("padding_0xc", "<u4"),
])

PROPERTY_INFO_DTYPE = np.dtype([
    ("name", "<u8"),
    ("bitfield_0x8", "<u4"),  # type:8, attr:8, size:15, disabled:1
    ("pad", "V36"),
])


@dataclass
class PropertyInfo:
    name: str
    prop_type: PropType
    raw_type: int
    attr: int
    size: int
    is_dynamic: bool
    is_disabled: bool


@dataclass
class ObjectInfo:
    dti: DTI
    props: list[PropertyInfo]


@dataclass
class XfsClass:
    """A deserialized object: DTI + ordered (name, values-list) props."""
    class_type: DTI
    props: list[tuple[str, list]] = field(default_factory=list)

    def get_prop(self, name: str):
        for pname, values in self.props:
            if pname == name:
                return values
        return None

    def __repr__(self):
        return f"XfsClass({self.class_type.name}, {dict(self.props)!r})"


_SCALARS = {
    PropType.u16: ("<H", 2),
    PropType.bool_: ("<B", 1),
    PropType.u8: ("<B", 1),
    PropType.f32: ("<f", 4),
    PropType.s32: ("<i", 4),
    PropType.u32: ("<I", 4),
    PropType.s16: ("<h", 2),
    PropType.s8: ("<b", 1),
    # extension scalars — the reference todo!()s on anything beyond its
    # 12 static / 6 dynamic types (mtserializer.rs:158,196); these follow
    # the engine's property size conventions
    PropType.u64: ("<Q", 8),
    PropType.s64: ("<q", 8),
    PropType.f64: ("<d", 8),
    PropType.time: ("<q", 8),
    PropType.color: ("<I", 4),            # packed RGBA
}

# fixed-layout composite types (tuples of scalars) — extensions, same
# caveat as above; vector3 stays special (explicit zero-pad assert)
_COMPOSITES = {
    PropType.point: "<2i",
    PropType.size: "<2i",
    PropType.rect: "<4i",
    PropType.range: "<2i",
    PropType.rangef: "<2f",
    PropType.rangeu16: "<2H",
    PropType.float2: "<2f",
    PropType.float3: "<3f",
    PropType.float4: "<4f",
    PropType.vector4: "<4f",
    PropType.quaternion: "<4f",
    PropType.float3x3: "<9f",
    PropType.float4x3: "<12f",
    PropType.float3x4: "<12f",
    PropType.float4x4: "<16f",
    PropType.matrix44: "<16f",
}


def _read_value(r: Reader, prop: PropertyInfo, objects: list[ObjectInfo]):
    pt = prop.prop_type
    if prop.is_dynamic:
        if pt == PropType.custom:
            (n,) = struct.unpack("<B", r.read(1))
            return [r.cstring(0x80) for _ in range(n)]
        if pt == PropType.classref:
            return _read_class(r, objects)
        if pt in (PropType.bool_, PropType.s16, PropType.s32, PropType.u32):
            fmt, size = _SCALARS[pt]
            v = struct.unpack(fmt, r.read(size))[0]
            return bool(v) if pt == PropType.bool_ else v
        raise NotImplementedError(f"dynamic prop type {pt!r}")

    if pt in (PropType.class_, PropType.classref):
        return _read_class(r, objects)
    if pt == PropType.vector3:
        x, y, z, pad = struct.unpack("<4f", r.read(16))
        if pad != 0.0:
            raise ValueError("vector3 padding not zero")
        return (x, y, z)
    if pt in (PropType.string, PropType.cstring):
        return r.cstring(0x200)
    if pt in _SCALARS:
        fmt, size = _SCALARS[pt]
        v = struct.unpack(fmt, r.read(size))[0]
        return bool(v) if pt == PropType.bool_ else v
    if pt in _COMPOSITES:
        fmt = _COMPOSITES[pt]
        return struct.unpack(fmt, r.read(struct.calcsize(fmt)))
    raise NotImplementedError(f"static prop type {pt!r}")


def _read_class(r: Reader, objects: list[ObjectInfo]) -> XfsClass | None:
    (class_info,) = struct.unpack("<I", r.read(4))
    if (class_info & 0xFFFE) == 0xFFFE:
        return None
    info = objects[(class_info >> 1) & 0x7FFF]
    r.read(8)  # unused u64 (mtserializer.rs:227-229)

    log.debug("class %s (%d props)", info.dti.name, len(info.props))
    props: list[tuple[str, list]] = []
    for prop in info.props:
        if prop.is_disabled:
            raise NotImplementedError("disabled prop")
        (count,) = struct.unpack("<I", r.read(4))
        values = [_read_value(r, prop, objects) for _ in range(count)]
        log.debug("  %s<%s>%s x%d", prop.name, prop.prop_type.name,
                  " dyn" if prop.is_dynamic else "", count)
        props.append((prop.name, values))
    return XfsClass(class_type=info.dti, props=props)


def strip_prpz(data: bytes) -> bytes:
    """Drop the 12-byte PRPZ wrapper if present (mtserializer.rs:355-372)."""
    if data[:4] == b"PRPZ":
        return data[12:]
    return data


def deserialize(src) -> XfsClass:
    r = Reader(src)
    if r.data[:4] == b"PRPZ":
        r = Reader(strip_prpz(r.data))
    h = r.struct(HEADER_DTYPE)
    if bytes(h["magic"]) != XFS_MAGIC.rstrip(b"\0"):
        raise parse_error(f"bad XFS magic {bytes(h['magic'])!r}", r.data, 0)
    if int(h["major_version"]) != XFS_MAJOR:
        raise parse_error(
            f"unsupported XFS major version {int(h['major_version'])}",
            r.data, 4,
        )
    log.debug("xfs: v%d.%d, %d object infos, %d-byte database",
              int(h["major_version"]), int(h["minor_version"]),
              int(h["object_num"]), int(h["database_size"]))

    db = r.read(int(h["database_size"]))
    object_num = int(h["object_num"])
    if object_num == 0:
        raise NotImplementedError("XFS with zero object infos")

    ptrs = np.frombuffer(db, "<u8", object_num)
    objects: list[ObjectInfo] = []
    for ptr in ptrs.astype(np.int64):
        rec = np.frombuffer(db, OBJECT_INFO_DTYPE, 1, offset=int(ptr))[0]
        dti = dti_mod.from_hash(int(rec["dti_hash"]))
        if dti is None:
            raise ValueError(f"unknown DTI hash 0x{int(rec['dti_hash']):08x}")
        num_props = int(rec["bitfield_0x8"]) & 0x7FFF
        if int(rec["bitfield_0x8"]) & 0x8000:
            raise NotImplementedError("is_init object info")
        raw_props = np.frombuffer(
            db, PROPERTY_INFO_DTYPE, num_props,
            offset=int(ptr) + OBJECT_INFO_DTYPE.itemsize,
        )
        props = []
        for p in raw_props:
            bf = int(p["bitfield_0x8"])
            raw_type = bf & 0xFF
            attr = (bf >> 8) & 0xFF
            props.append(PropertyInfo(
                name=read_cstring(db, int(p["name"])),
                prop_type=PropType.from_raw(raw_type),
                raw_type=raw_type,
                attr=attr,
                size=(bf >> 16) & 0x7FFF,
                is_dynamic=bool(attr & PROP_ATTR_DYNAMIC),
                is_disabled=bool(bf & ~0x7FFFFFFF),
            ))
        objects.append(ObjectInfo(dti=dti, props=props))

    cls = _read_class(r, objects)
    if cls is None:
        raise ValueError("root class is null")
    return cls


# ---------------------------------------------------------------------------
# serializer (fixtures / tooling; not present in the reference)
# ---------------------------------------------------------------------------


@dataclass
class PropSpec:
    """A property declaration for serialization."""
    name: str
    prop_type: PropType
    attr: int = 0

    @property
    def is_dynamic(self):
        return bool(self.attr & PROP_ATTR_DYNAMIC)


@dataclass
class ClassSpec:
    dti_name: str
    props: list[PropSpec]


def _write_value(out: bytearray, pt: PropType, value, class_index):
    if pt in (PropType.class_, PropType.classref):
        _write_class(out, value, class_index)
    elif pt == PropType.vector3:
        out += struct.pack("<4f", *value, 0.0)
    elif pt in (PropType.string, PropType.cstring):
        out += str(value).encode("shift_jis") + b"\0"
    elif pt == PropType.custom:
        out += struct.pack("<B", len(value))
        for s in value:
            out += str(s).encode("shift_jis") + b"\0"
    elif pt in _SCALARS:
        fmt, _ = _SCALARS[pt]
        out += struct.pack(
            fmt, float(value) if pt in (PropType.f32, PropType.f64)
            else int(value)
        )
    elif pt in _COMPOSITES:
        out += struct.pack(_COMPOSITES[pt], *value)
    else:
        raise NotImplementedError(f"serialize prop type {pt!r}")


def _write_class(out: bytearray, cls, class_index: dict):
    if cls is None:
        out += struct.pack("<I", 0xFFFE)
        return
    dti_name, values_by_prop = cls  # (dti_name, {prop_name: [values]})
    idx, spec = class_index[dti_name]
    out += struct.pack("<I", (idx << 1))
    out += struct.pack("<Q", 0)
    for prop in spec.props:
        values = values_by_prop.get(prop.name, [])
        out += struct.pack("<I", len(values))
        for v in values:
            _write_value(out, prop.prop_type, v, class_index)


def serialize(root, class_specs: list[ClassSpec], minor_version: int = 0) -> bytes:
    """Serialize ``root = (dti_name, {prop: [values]})`` into XFS bytes."""
    # database
    db = bytearray(8 * len(class_specs))  # ptr table placeholder
    names_pos: dict[str, int] = {}
    ptrs = []
    name_blobs: list[tuple[int, str]] = []

    # lay out object infos first, then the string pool
    infos = []
    for spec in class_specs:
        ptrs.append(len(db))
        rec = np.zeros(1, dtype=OBJECT_INFO_DTYPE)
        dti = dti_mod.from_name(spec.dti_name)
        if dti is None:
            raise ValueError(f"unknown DTI {spec.dti_name!r}")
        rec[0]["dti_hash"] = dti.hash
        rec[0]["bitfield_0x8"] = len(spec.props) & 0x7FFF
        db += rec.tobytes()
        prop_base = len(db)
        db += b"\0" * (PROPERTY_INFO_DTYPE.itemsize * len(spec.props))
        infos.append((prop_base, spec))

    for prop_base, spec in infos:
        for i, prop in enumerate(spec.props):
            if prop.name not in names_pos:
                names_pos[prop.name] = len(db)
                db += prop.name.encode("shift_jis") + b"\0"
            rec = np.zeros(1, dtype=PROPERTY_INFO_DTYPE)
            rec[0]["name"] = names_pos[prop.name]
            raw_type = (int(prop.prop_type)
                        if prop.prop_type != PropType.custom else 0x80)
            rec[0]["bitfield_0x8"] = (
                (raw_type & 0xFF) | ((prop.attr & 0xFF) << 8)
            )
            off = prop_base + i * PROPERTY_INFO_DTYPE.itemsize
            db[off:off + PROPERTY_INFO_DTYPE.itemsize] = rec.tobytes()

    db[:8 * len(ptrs)] = np.asarray(ptrs, dtype="<u8").tobytes()

    class_index = {spec.dti_name: (i, spec) for i, spec in enumerate(class_specs)}
    body = bytearray()
    _write_class(body, root, class_index)

    h = np.zeros(1, dtype=HEADER_DTYPE)
    h[0]["magic"] = XFS_MAGIC
    h[0]["major_version"] = XFS_MAJOR
    h[0]["minor_version"] = minor_version
    h[0]["max_object_id"] = len(class_specs)
    h[0]["object_num"] = len(class_specs)
    h[0]["database_size"] = len(db)
    return h.tobytes() + bytes(db) + bytes(body)
