"""MT Framework CRC32 variant.

The engine hashes names with the standard CRC-32 (IEEE 802.3) table but with
two twists compared to the usual zlib convention (reference:
``src/util/crc.rs:36-50``):

* hashing stops at the first NUL byte (names are C strings),
* there is **no** final XOR — the caller passes the initial value (normally
  ``0xffffffff``) and receives the raw register.

Because the polynomial/table is the standard one, we can delegate the byte
crunching to the C implementation in :mod:`zlib`:
``zlib.crc32`` initialises the register with ``prev ^ 0xffffffff`` and XORs
the result with ``0xffffffff``, so conjugating the init/result recovers the
MT convention.

Known vector (reference ``crc.rs:52-64``): ``crc32(b"MtObject") == 0x2ea10ceb``.

DTI hashes additionally mask to 31 bits: ``crc32(name) & 0x7fffffff``
(reference ``dti.rs:148-193`` test sweep).
"""

import zlib

__all__ = ["crc32", "dti_hash", "crc32_py"]

_MASK = 0xFFFFFFFF


def _truncate_at_nul(data: bytes) -> bytes:
    i = data.find(0)
    return data if i < 0 else data[:i]


def crc32(data, init: int = 0xFFFFFFFF) -> int:
    """MT-variant CRC32 of ``data`` (bytes or str), stopping at the first NUL."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    data = _truncate_at_nul(data)
    return (zlib.crc32(data, (init & _MASK) ^ _MASK) ^ _MASK) & _MASK


def dti_hash(name) -> int:
    """31-bit DTI hash of a class name."""
    return crc32(name) & 0x7FFFFFFF


# -- table-driven fallback (kept for cross-checking the zlib fast path) -------

_TABLE = None


def _make_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0xEDB88320 if c & 1 else c >> 1
        table.append(c)
    return table


def crc32_py(data, init: int = 0xFFFFFFFF) -> int:
    """Pure-Python table implementation (mirrors the engine's inner loop)."""
    global _TABLE
    if _TABLE is None:
        _TABLE = _make_table()
    if isinstance(data, str):
        data = data.encode("utf-8")
    val = init & _MASK
    for b in data:
        if b == 0:
            break
        val = _TABLE[(b ^ val) & 0xFF] ^ (val >> 8)
    return val & _MASK
