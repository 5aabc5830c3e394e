"""rGuiMessage (.gmd) — localized GUI message tables.

Layout (reference ``src/rguimessage.rs``):

* header: magic ``"GMD\\0"``, version 0x10302, language id, u64 update
  timestamp, index/message counts, label and message buffer sizes, package
  name length (``rguimessage.rs:14-27``).
* NUL-terminated package name.
* 0x20 index items: message index, double/triple CRC chain of the label
  (``h=crc(label); ha=crc(label,h); hb=crc(label,ha)``), label offset, hash
  link (``rguimessage.rs:29-39,110-114``).
* a 256-entry u64 hash table keyed by ``crc(label) & 0xff`` (index 0 stored
  as -1 to distinguish from nullptr) — present only when ``index_num != 0``.
* label buffer (NUL-joined), then message buffer (NUL-joined UTF-8).

``save`` reproduces the reference writer byte for byte
(``rguimessage.rs:131-205``), including the 0xcdcdcdcd index padding.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

from ..utils import Reader, crc32, read_cstring

GMD_MAGIC = b"GMD\0"
GMD_VERSION = 0x10302
HASH_TABLE_LEN = 256

HEADER_DTYPE = np.dtype([
    ("magic", "S4"),
    ("version", "<u4"),
    ("language_id", "<u4"),
    ("update_time", "<u8"),
    ("index_num", "<u4"),
    ("message_num", "<u4"),
    ("index_name_buf_size", "<u4"),
    ("message_buffer_size", "<u4"),
    ("package_name_len", "<u4"),
])

INDEX_ITEM_DTYPE = np.dtype([
    ("message_index", "<u4"),
    ("hash_a", "<u4"),
    ("hash_b", "<u4"),
    ("padding", "<u4"),
    ("label_offset", "<u8"),
    ("hash_link", "<u8"),
])


@dataclass
class GuiMessage:
    label: str
    message: str


# Index 0 can't be told apart from "empty slot"/"end of chain", so both
# the 256-slot table and the per-item hash_link store index 0 as u64 max
# (the reference does this for the table, rguimessage.rs:80-83; its
# writer todo!()s on any collision, rguimessage.rs:163 — chains here are
# the fix: colliding labels append to the slot's chain tail).
_NULL = 0
_ZERO_ENC = 0xFFFFFFFFFFFFFFFF


def _enc_index(i: int) -> int:
    return _ZERO_ENC if i == 0 else i


def _dec_index(v: int) -> int:
    return 0 if v == _ZERO_ENC else v


def _verify_hash_chains(table, index, strict: bool = False) -> None:
    """Diagnose the hash table by walking ``table[crc & 0xff]`` →
    ``hash_link`` chains. The check is TOLERANT of valid-but-unusual
    writer layouts (the reference never verifies chains at all):
    a slot pointing into the middle of another chain just stops the
    walk; only structurally impossible data raises (an index out of
    range, or a cycle within one walk); labels unreachable by hash
    lookup are a warning, not an error — the sequential index is
    intact and parsing can proceed."""
    reached: set[int] = set()
    n = len(index)
    for slot in range(HASH_TABLE_LEN):
        v = int(table[slot])
        if v == _NULL:
            continue
        i = _dec_index(v)
        walk: set[int] = set()
        while True:
            if i >= n:
                raise ValueError(f"GMD hash chain corrupt at slot {slot}")
            if i in walk:
                raise ValueError(f"GMD hash chain cycle at slot {slot}")
            if i in reached:
                break                     # joined a chain seen earlier
            walk.add(i)
            reached.add(i)
            nxt = int(index[i]["hash_link"])
            if nxt == _NULL:
                break
            i = _dec_index(nxt)
    if len(reached) != n:
        msg = (f"GMD hash table reaches {len(reached)} of {n} labels — "
               "hash lookups will miss some; parsing continues from the "
               "sequential index")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, RuntimeWarning)


class GuiMessageFile:
    def __init__(self, language_id: int = 0, package_name: str = "",
                 update_time: int = 0, messages: list[GuiMessage] | None = None):
        self.language_id = language_id
        self.package_name = package_name
        self.update_time = update_time
        self.messages: list[GuiMessage] = messages or []

    @classmethod
    def parse(cls, src, strict: bool = False) -> "GuiMessageFile":
        r = Reader(src)
        h = r.struct(HEADER_DTYPE)
        if bytes(h["magic"]) != GMD_MAGIC.rstrip(b"\0"):
            raise ValueError(f"bad GMD magic {bytes(h['magic'])!r}")
        if int(h["version"]) != GMD_VERSION:
            raise ValueError(f"unsupported GMD version 0x{int(h['version']):x}")

        pkg_raw = r.read(int(h["package_name_len"]) + 1)
        package_name = pkg_raw.split(b"\0")[0].decode("utf-8", errors="replace")

        index = r.struct_array(INDEX_ITEM_DTYPE, int(h["index_num"]))
        table = None
        if int(h["index_num"]) != 0:
            table = r.struct_array(np.dtype("<u8"), HASH_TABLE_LEN)

        label_buf = r.read(int(h["index_name_buf_size"]))
        message_buf = r.read(int(h["message_buffer_size"]))

        # NUL-split message buffer (rguimessage.rs:91-103)
        messages = [m.decode("utf-8", errors="replace")
                    for m in message_buf.split(b"\0")[:-1]]

        out = []
        for item in index:
            label = read_cstring(label_buf, int(item["label_offset"]),
                                 encoding="utf-8")
            lb = label.encode("utf-8")
            hsh = crc32(lb)
            ha = crc32(lb, hsh)
            hb = crc32(lb, ha)
            if ha != int(item["hash_a"]) or hb != int(item["hash_b"]):
                raise ValueError(f"GMD label hash mismatch for {label!r}")
            out.append(GuiMessage(label, messages[int(item["message_index"])]))

        if table is not None:
            _verify_hash_chains(table, index, strict=strict)

        return cls(
            language_id=int(h["language_id"]),
            package_name=package_name,
            update_time=int(h["update_time"]),
            messages=out,
        )

    def tobytes(self) -> bytes:
        label_buf = bytearray()
        message_buf = bytearray()
        label_offsets = [0]
        for m in self.messages:
            lb = m.label.encode("utf-8")
            label_buf += lb + b"\0"
            label_offsets.append(label_offsets[-1] + len(lb) + 1)
            message_buf += m.message.encode("utf-8") + b"\0"

        hash_table = np.zeros(HASH_TABLE_LEN, dtype="<u8")
        index = np.zeros(len(self.messages), dtype=INDEX_ITEM_DTYPE)
        tails: dict[int, int] = {}       # slot → chain tail index
        for i, m in enumerate(self.messages):
            lb = m.label.encode("utf-8")
            hsh = crc32(lb)
            ha = crc32(lb, hsh)
            hb = crc32(lb, ha)
            slot = hsh & 0xFF
            if slot not in tails:
                hash_table[slot] = np.uint64(_enc_index(i))
            else:
                index[tails[slot]]["hash_link"] = np.uint64(_enc_index(i))
            tails[slot] = i
            index[i]["message_index"] = i
            index[i]["hash_a"] = ha
            index[i]["hash_b"] = hb
            index[i]["padding"] = 0xCDCDCDCD
            index[i]["label_offset"] = label_offsets[i]
            index[i]["hash_link"] = 0

        h = np.zeros(1, dtype=HEADER_DTYPE)
        h[0]["magic"] = GMD_MAGIC
        h[0]["version"] = GMD_VERSION
        h[0]["language_id"] = self.language_id
        h[0]["update_time"] = self.update_time
        h[0]["index_num"] = len(self.messages)
        h[0]["message_num"] = len(self.messages)
        h[0]["index_name_buf_size"] = len(label_buf)
        h[0]["message_buffer_size"] = len(message_buf)
        h[0]["package_name_len"] = len(self.package_name.encode("utf-8"))

        return (
            h.tobytes()
            + self.package_name.encode("utf-8") + b"\0"
            + index.tobytes()
            + hash_table.tobytes()
            + bytes(label_buf)
            + bytes(message_buf)
        )

    def save(self, fp):
        fp.write(self.tobytes())

    # -- JSON interop (gmdtool parity, rguimessage.rs:42-56) ------------------

    def to_json_obj(self) -> dict:
        return {
            "update_time": self.update_time,
            "language_id": self.language_id,
            "package_name": self.package_name,
            "messages": [
                {"label": m.label, "message": m.message} for m in self.messages
            ],
        }

    @classmethod
    def from_json_obj(cls, obj: dict) -> "GuiMessageFile":
        return cls(
            language_id=obj["language_id"],
            package_name=obj["package_name"],
            update_time=obj["update_time"],
            messages=[GuiMessage(m["label"], m["message"])
                      for m in obj["messages"]],
        )
