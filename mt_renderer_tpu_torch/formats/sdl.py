"""rScheduler (.sdl) — timeline tracks animating object properties.

Layout (reference ``src/rscheduler.rs``):

* header: magic ``"SDL\\0"``, version 0x16, track count, crc, base track,
  ``metadata`` base offset for name/resource pointers
  (``rscheduler.rs:66-80``).
* 0x30 tracks: bitfield (track_type:8 prop_type:8 key_num:16), parent,
  name pointer (relative to ``metadata``), DTI-or-prop-index field, unit
  group, keyframe and key-value array offsets (``rscheduler.rs:35-63``).
* keyframes: u32 = 24-bit frame number | 8-bit interpolation mode
  (``rscheduler.rs:144-150``).
* values by track type: BOOL → u8, INT → u32, FLOAT → f32, RESOURCE →
  u64 pointer → (metadata-relative) u32 DTI hash + path C string
  (``rscheduler.rs:152-209``).

Unlike the reference (which logs and returns an empty struct,
``rscheduler.rs:217``) this parser materialises tracks and keyframes —
they drive per-frame parameter animation on device.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from .. import dti as dti_mod
from ..dti import DTI
from ..utils import Reader, get_logger, read_cstring

log = get_logger("formats.sdl")

SDL_MAGIC = b"SDL\0"
SDL_VERSION = 0x16

HEADER_DTYPE = np.dtype([
    ("magic", "S4"),
    ("version", "<u2"),
    ("track_num", "<u2"),
    ("crc", "<u4"),
    ("bitfield_c", "<u4"),
    ("base_track", "<u4"),
    ("pad_14", "<u4"),
    ("metadata", "<u8"),
])

TRACK_DTYPE = np.dtype([
    ("bitfield_0", "<u4"),   # track_type:8, prop_type:8, key_num:16
    ("field_4", "<u4"),
    ("track_prop_name", "<u8"),
    ("field_10", "<u4"),
    ("pad_14", "<u4"),
    ("unit_group", "<u8"),
    ("key_frame", "<u8"),
    ("key_value", "<u8"),
])


class TrackType(enum.IntEnum):
    TYPE_UNKNOWN = 0
    TYPE_ROOT = 1
    TYPE_UNIT = 2
    TYPE_SYSTEM = 3
    TYPE_SCHEDULER = 4
    TYPE_OBJECT = 5
    TYPE_INT = 6
    TYPE_INT64 = 7
    TYPE_VECTOR = 8
    TYPE_FLOAT = 9
    TYPE_FLOAT64 = 10
    TYPE_BOOL = 11
    TYPE_REF = 12
    TYPE_RESOURCE = 13
    TYPE_STRING = 14
    TYPE_EVENT = 15
    TYPE_MATRIX = 16


_VALUE_TRACKS = {
    TrackType.TYPE_INT, TrackType.TYPE_INT64, TrackType.TYPE_VECTOR,
    TrackType.TYPE_FLOAT, TrackType.TYPE_FLOAT64, TrackType.TYPE_BOOL,
    TrackType.TYPE_REF, TrackType.TYPE_RESOURCE, TrackType.TYPE_STRING,
    TrackType.TYPE_EVENT, TrackType.TYPE_MATRIX,
}


@dataclass
class Key:
    frame: int
    mode: int
    value: object = None


@dataclass
class Track:
    track_type: TrackType
    prop_type: int
    name: str
    parent: int
    unit_dti: DTI | None = None
    keys: list[Key] = field(default_factory=list)


class SchedulerFile:
    def __init__(self, src):
        r = Reader(src)
        data = r.data
        h = r.struct(HEADER_DTYPE)
        if bytes(h["magic"]) != SDL_MAGIC.rstrip(b"\0"):
            raise ValueError(f"bad SDL magic {bytes(h['magic'])!r}")
        if int(h["version"]) != SDL_VERSION:
            raise ValueError(f"unsupported SDL version 0x{int(h['version']):x}")
        meta = int(h["metadata"])
        self.base_track = int(h["base_track"])

        raw_tracks = r.struct_array(TRACK_DTYPE, int(h["track_num"]))
        self.tracks: list[Track] = []
        for t in raw_tracks:
            bf = int(t["bitfield_0"])
            ttype = TrackType(bf & 0xFF)
            prop_type = (bf >> 8) & 0xFF
            key_num = (bf >> 16) & 0xFFFF
            name = read_cstring(data, meta + int(t["track_prop_name"]))

            log.debug("track %s %r: prop_type=%d keys=%d",
                      ttype.name, name, prop_type, key_num)
            track = Track(
                track_type=ttype, prop_type=prop_type, name=name,
                parent=int(t["field_4"]),
            )
            if ttype in (TrackType.TYPE_UNIT, TrackType.TYPE_SYSTEM):
                track.unit_dti = dti_mod.from_hash(int(t["field_10"]))

            if ttype in _VALUE_TRACKS and key_num:
                frames = np.frombuffer(
                    data, "<u4", key_num, offset=int(t["key_frame"])
                )
                vofs = int(t["key_value"])
                for i, info in enumerate(frames):
                    info = int(info)
                    key = Key(frame=info & 0xFFFFFF, mode=(info >> 24) & 0xFF)
                    if ttype == TrackType.TYPE_BOOL:
                        key.value = bool(data[vofs + i])
                    elif ttype == TrackType.TYPE_INT:
                        key.value = int(
                            np.frombuffer(data, "<u4", 1, offset=vofs + i * 4)[0]
                        )
                    elif ttype == TrackType.TYPE_FLOAT:
                        key.value = float(
                            np.frombuffer(data, "<f4", 1, offset=vofs + i * 4)[0]
                        )
                    elif ttype == TrackType.TYPE_RESOURCE:
                        ptr = int(
                            np.frombuffer(data, "<u8", 1, offset=vofs + i * 8)[0]
                        )
                        if ptr:
                            dti_offs = meta + ptr
                            dti_hash = int(
                                np.frombuffer(data, "<u4", 1, offset=dti_offs)[0]
                            )
                            path = read_cstring(data, dti_offs + 4)
                            key.value = (dti_hash, path)
                    else:
                        raise NotImplementedError(f"key values for {ttype!r}")
                    track.keys.append(key)
            self.tracks.append(track)

    def value_at(self, track: Track, frame: float):
        """Sample a track at ``frame`` (step interpolation, host-side)."""
        value = None
        for key in track.keys:
            if key.frame <= frame:
                value = key.value
            else:
                break
        return value


def write_scheduler(tracks: list[Track]) -> bytes:
    """Serialize tracks into a .sdl byte stream (fixtures/tooling)."""
    header_size = HEADER_DTYPE.itemsize
    tracks_size = TRACK_DTYPE.itemsize * len(tracks)

    # region after tracks: keyframe/value arrays, then metadata (names)
    blobs = bytearray()
    blob_base = header_size + tracks_size

    raw = np.zeros(len(tracks), dtype=TRACK_DTYPE)
    name_entries: list[tuple[int, str]] = []

    pending_names = bytearray()
    name_offsets: dict[str, int] = {}

    def intern(s: str) -> int:
        if s not in name_offsets:
            name_offsets[s] = len(pending_names)
            pending_names.extend(s.encode("shift_jis") + b"\0")
        return name_offsets[s]

    resource_blobs = []
    for i, t in enumerate(tracks):
        key_num = len(t.keys)
        raw[i]["bitfield_0"] = (
            (int(t.track_type) & 0xFF)
            | ((t.prop_type & 0xFF) << 8)
            | ((key_num & 0xFFFF) << 16)
        )
        raw[i]["field_4"] = t.parent
        raw[i]["track_prop_name"] = intern(t.name)
        if t.unit_dti is not None:
            raw[i]["field_10"] = t.unit_dti.hash

        if t.track_type in _VALUE_TRACKS and key_num:
            frames = np.asarray(
                [(k.frame & 0xFFFFFF) | ((k.mode & 0xFF) << 24) for k in t.keys],
                dtype="<u4",
            )
            raw[i]["key_frame"] = blob_base + len(blobs)
            blobs += frames.tobytes()
            raw[i]["key_value"] = blob_base + len(blobs)
            if t.track_type == TrackType.TYPE_BOOL:
                blobs += bytes(int(bool(k.value)) for k in t.keys)
            elif t.track_type == TrackType.TYPE_INT:
                blobs += np.asarray([k.value for k in t.keys], dtype="<u4").tobytes()
            elif t.track_type == TrackType.TYPE_FLOAT:
                blobs += np.asarray([k.value for k in t.keys], dtype="<f4").tobytes()
            elif t.track_type == TrackType.TYPE_RESOURCE:
                ptr_pos = len(blobs)
                blobs += b"\0" * (8 * key_num)
                for j, k in enumerate(t.keys):
                    if k.value is None:
                        continue
                    dti_hash, path = k.value
                    # resource payloads live in the metadata region
                    resource_blobs.append((ptr_pos + 8 * j, dti_hash, path))
            else:
                raise NotImplementedError(f"write keys for {t.track_type!r}")

    metadata_ofs = blob_base + len(blobs)
    meta = bytearray(pending_names)
    for ptr_pos, dti_hash, path in resource_blobs:
        rel = len(meta)
        meta += np.uint32(dti_hash).tobytes() + path.encode("shift_jis") + b"\0"
        blobs[ptr_pos:ptr_pos + 8] = np.uint64(rel).tobytes()

    h = np.zeros(1, dtype=HEADER_DTYPE)
    h[0]["magic"] = SDL_MAGIC
    h[0]["version"] = SDL_VERSION
    h[0]["track_num"] = len(tracks)
    h[0]["metadata"] = metadata_ofs
    del name_entries
    return h.tobytes() + raw.tobytes() + bytes(blobs) + bytes(meta)
