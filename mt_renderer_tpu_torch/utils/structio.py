"""Zero-copy binary record reading on top of NumPy structured dtypes.

The reference framework reads every on-disk record through a generic
little-endian struct reader (``src/util/read_struct.rs``).
Here each format module declares its records as NumPy structured dtypes
(``align=False`` ⇒ packed, matching ``#[repr(C, packed)]``) and uses these
helpers to view them directly out of a byte buffer — no per-field parsing
loops, no copies for arrays.

Strings in MT files are NUL-terminated and SHIFT-JIS encoded
(``read_struct.rs:60-86``).
"""

from __future__ import annotations

import io

import numpy as np

__all__ = [
    "Reader",
    "read_struct",
    "read_struct_array",
    "cstr",
    "read_cstring",
    "hexdump",
]


def cstr(raw, encoding: str = "shift_jis") -> str:
    """Decode a NUL-terminated byte region (bytes / numpy void field)."""
    if isinstance(raw, np.ndarray):
        raw = raw.tobytes()
    elif not isinstance(raw, (bytes, bytearray)):
        raw = bytes(raw)
    i = raw.find(0)
    if i >= 0:
        raw = raw[:i]
    return raw.decode(encoding, errors="replace")


def read_struct_array(buf, dtype: np.dtype, count: int, offset: int = 0) -> np.ndarray:
    """View ``count`` packed records of ``dtype`` at ``offset`` in ``buf``."""
    dtype = np.dtype(dtype)
    need = offset + count * dtype.itemsize
    if len(buf) < need:
        raise ValueError(
            f"not enough bytes to read array: {len(buf)} < {need} "
            f"({count} x {dtype.itemsize} at +{offset})"
        )
    return np.frombuffer(buf, dtype=dtype, count=count, offset=offset)


def read_struct(buf, dtype: np.dtype, offset: int = 0):
    """Read a single record; returns a zero-dim structured scalar."""
    return read_struct_array(buf, dtype, 1, offset)[0]


def read_cstring(buf, offset: int = 0, max_size: int | None = None,
                 encoding: str = "shift_jis") -> str:
    """Read a NUL-terminated string starting at ``offset``."""
    end = len(buf) if max_size is None else min(len(buf), offset + max_size)
    view = bytes(buf[offset:end])
    return cstr(view, encoding)


class Reader:
    """Seekable reader that serves packed structs from a stream or buffer.

    Most formats are parsed from a fully materialised ``bytes`` (archives hand
    us decompressed blobs); loose files are read once into memory. Offsets in
    MT headers are absolute file offsets, so buffer-oriented access is the
    natural model.
    """

    def __init__(self, src):
        if isinstance(src, (bytes, bytearray, memoryview)):
            self._buf = bytes(src)
        elif hasattr(src, "read"):
            pos = src.tell() if src.seekable() else None
            if pos:
                src.seek(0)
            self._buf = src.read()
        else:
            raise TypeError(f"unsupported source: {type(src)}")
        self._pos = 0

    @property
    def data(self) -> bytes:
        return self._buf

    def __len__(self):
        return len(self._buf)

    def tell(self) -> int:
        return self._pos

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            self._pos = offset
        elif whence == io.SEEK_CUR:
            self._pos += offset
        elif whence == io.SEEK_END:
            self._pos = len(self._buf) + offset
        else:
            raise ValueError(whence)
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = len(self._buf) - self._pos
        out = self._buf[self._pos:self._pos + n]
        if len(out) != n:
            raise EOFError(f"wanted {n} bytes at +{self._pos}, got {len(out)}")
        self._pos += n
        return out

    def struct(self, dtype: np.dtype):
        dtype = np.dtype(dtype)
        rec = read_struct(self._buf, dtype, self._pos)
        self._pos += dtype.itemsize
        return rec

    def struct_array(self, dtype: np.dtype, count: int) -> np.ndarray:
        dtype = np.dtype(dtype)
        arr = read_struct_array(self._buf, dtype, count, self._pos)
        self._pos += dtype.itemsize * count
        return arr

    def cstring(self, max_size: int = 0x200, encoding: str = "shift_jis") -> str:
        """Read a NUL-terminated string, advancing past the terminator."""
        end = min(len(self._buf), self._pos + max_size + 1)
        chunk = self._buf[self._pos:end]
        i = chunk.find(0)
        if i < 0:
            i = len(chunk)
            self._pos += i
        else:
            self._pos += i + 1
        return chunk[:i].decode(encoding, errors="replace")


def hexdump(data, chunk_size: int = 16) -> str:
    """Debug hexdump (reference ``util/hexdump.rs:3-34``)."""
    if isinstance(data, np.ndarray):
        data = data.tobytes()
    lines = []
    for base in range(0, len(data), chunk_size):
        chunk = data[base:base + chunk_size]
        hexpart = "".join(f"{b:02x} " for b in chunk)
        hexpart += "   " * (chunk_size - len(chunk))
        ascii_part = "".join(chr(b) if chr(b).isalnum() and b < 128 else "." for b in chunk)
        lines.append(f"{hexpart} | {ascii_part}")
    return "\n".join(lines) + ("\n" if lines else "")
