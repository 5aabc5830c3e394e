"""DTI — the MT Framework runtime type registry.

Every resource and serialized object in the engine is tagged with a 31-bit
CRC of its class name (the "DTI hash").  The registry maps hashes to class
metadata: name, instance size, resource file extension, parent class, and
serialized property definitions.

The data ships as ``dti_registry.json``, a byte-equal copy of the JAX
package's registry (generated by ``tools/gen_dti_registry.py`` from an
engine class-metadata dump). Unlike the reference — whose
``DTI::is_type_of`` parent walk is an unimplemented ``todo!()``
(``dti.rs:138-145``) — this registry resolves parent chains.

``PropType`` is the 80-variant serialized property type enum
(``dti.rs:6-85``); values at or past ``type_end`` collapse to ``custom``
(``dti.rs:87-95``).
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from functools import lru_cache
from pathlib import Path

from ..utils.crc import dti_hash

_REGISTRY_PATH = Path(__file__).with_name("dti_registry.json")

PROP_ATTR_ARRAY = 32
PROP_ATTR_DYNAMIC = 128


class PropType(enum.IntEnum):
    undefined = 0
    class_ = 1
    classref = 2
    bool_ = 3
    u8 = 4
    u16 = 5
    u32 = 6
    u64 = 7
    s8 = 8
    s16 = 9
    s32 = 10
    s64 = 11
    f32 = 12
    f64 = 13
    string = 14
    color = 15
    point = 16
    size = 17
    rect = 18
    matrix44 = 19
    vector3 = 20
    vector4 = 21
    quaternion = 22
    property = 23
    event = 24
    group = 25
    pagebegin = 26
    pageend = 27
    event32 = 28
    array = 29
    propertylist = 30
    groupend = 31
    cstring = 32
    time = 33
    float2 = 34
    float3 = 35
    float4 = 36
    float3x3 = 37
    float4x3 = 38
    float4x4 = 39
    easecurve = 40
    line = 41
    linesegment = 42
    ray = 43
    plane = 44
    sphere = 45
    capsule = 46
    aabb = 47
    obb = 48
    cylinder = 49
    triangle = 50
    cone = 51
    torus = 52
    ellpsoid = 53
    range = 54
    rangef = 55
    rangeu16 = 56
    hermitecurve = 57
    enumlist = 58
    float3x4 = 59
    linesegment4 = 60
    aabb4 = 61
    oscillator = 62
    variable = 63
    vector2 = 64
    matrix33 = 65
    rect3d_xz = 66
    rect3d = 67
    rect3d_collision = 68
    plane_xz = 69
    ray_y = 70
    pointf = 71
    sizef = 72
    rectf = 73
    event64 = 74

    type_end = 75
    custom = 0x80

    @classmethod
    def from_raw(cls, value: int) -> "PropType":
        """Unknown/extended values collapse to ``custom`` (dti.rs:87-95)."""
        if value >= cls.type_end:
            return cls.custom
        return cls(value)


@dataclass(frozen=True)
class PropDef:
    name: str
    type: str | None
    attr: int


@dataclass(frozen=True)
class DTI:
    name: str
    hash: int
    size: int | None = None
    file_ext: str | None = None
    parent_name: str | None = None
    props: tuple[PropDef, ...] = field(default_factory=tuple)

    @property
    def parent(self) -> "DTI | None":
        if self.parent_name is None:
            return None
        return from_name(self.parent_name)

    def is_type_of(self, other: "DTI") -> bool:
        """True if ``self`` is ``other`` or inherits from it (parent walk)."""
        node: DTI | None = self
        seen = set()
        while node is not None and node.hash not in seen:
            if node.hash == other.hash:
                return True
            seen.add(node.hash)
            node = node.parent
        return False

    def __repr__(self):
        return f"DTI({self.name!r}, 0x{self.hash:08x}, ext={self.file_ext!r})"


class Registry:
    def __init__(self, path: Path = _REGISTRY_PATH):
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
        self.by_hash: dict[int, DTI] = {}
        self.by_name: dict[str, DTI] = {}
        for e in raw:
            props = tuple(
                PropDef(p["name"], p.get("type"), p.get("attr", 0))
                for p in e.get("props", [])
            )
            d = DTI(
                name=e["name"],
                hash=e["hash"],
                size=e.get("size"),
                file_ext=e.get("ext"),
                parent_name=e.get("parent"),
                props=props,
            )
            # duplicate hashes were already dropped at generation time
            self.by_hash[d.hash] = d
            self.by_name.setdefault(d.name, d)

    def from_hash(self, h: int) -> DTI | None:
        return self.by_hash.get(h)

    def from_name(self, name: str) -> DTI | None:
        d = self.by_name.get(name)
        if d is not None:
            return d
        # names not in the dump still hash deterministically
        return self.by_hash.get(dti_hash(name))

    def __len__(self):
        return len(self.by_hash)

    def __iter__(self):
        return iter(self.by_hash.values())


@lru_cache(maxsize=1)
def registry() -> Registry:
    return Registry()


def from_hash(h: int) -> DTI | None:
    return registry().from_hash(h)


def from_name(name: str) -> DTI | None:
    return registry().from_name(name)
