"""Minimal dependency-free PNG writer for headless frame output."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """Encode (H, W, 4) / (H, W, 3) uint8 (or (H, W) grayscale) to PNG
    bytes. ``level``: zlib effort — streaming frontends use 1 (the frame
    is transient; encode speed beats size)."""
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w, c = img.shape
    color_type = {3: 2, 4: 6}[c]

    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body)
        )

    hdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", hdr)
        + chunk(b"IDAT", zlib.compress(raw, level))
        + chunk(b"IEND", b"")
    )


def write_png(path, img: np.ndarray) -> None:
    """Write (H, W, 4) or (H, W, 3) uint8 (or (H, W) grayscale) to PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
