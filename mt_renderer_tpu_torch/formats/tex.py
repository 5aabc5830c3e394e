"""rTexture (.tex) — engine texture container.

16-byte bit-packed header (reference ``src/rtexture.rs:24-78``):

====  =========  ====================================
word  bits       field
====  =========  ====================================
0     0-31       magic ``"TEX\\0"``
1     0-15       version
1     16-23      attr
1     24-27      prebias (width/height scale shift)
1     28-31      type (TT_2D == 2 is the only supported)
2     0-5        level_count (mips)
2     6-18       width  (<< prebias)
2     19-31      height (<< prebias)
3     0-7        array_count
3     8-15       format
3     16-28      depth
3     29/30/31   auto_resize / render_target / use_vtf
====  =========  ====================================

Followed by ``array_count * level_count`` u64 absolute image offsets, then
image payloads. Formats used by the game data (``rtexture.rs:152-161``):
7 = RGBA8, 19 = BC1, 42/54 = BC7.

The reference uploads BCn blocks for GPU hardware decode. This package
decodes RGBA8 only: the BCn decoders come with the compressed-resident
pools (ROADMAP Queue 1, slice 4).
"""

from __future__ import annotations

import enum

import numpy as np

from ..utils import Reader, get_logger, parse_error

log = get_logger("formats.tex")

TEX_MAGIC = b"TEX\0"

HEADER_DTYPE = np.dtype([
    ("magic", "S4"),
    ("bitfield_4", "<u4"),
    ("bitfield_8", "<u4"),
    ("bitfield_c", "<u4"),
])


class TextureType(enum.IntEnum):
    TT_UNDEFINED = 0
    TT_1D = 1
    TT_2D = 2
    TT_3D = 3
    TT_1DARRAY = 4
    TT_2DARRAY = 5
    TT_CUBE = 6
    TT_CUBEARRAY = 7
    TT_2DMS = 8
    TT_2DMSARRAY = 9


class TextureFormat(enum.IntEnum):
    RGBA8 = 7
    BC1 = 19
    BC7_42 = 42
    BC7 = 54


def _block_compressed(fmt: int) -> bool:
    return fmt in (TextureFormat.BC1, TextureFormat.BC7, TextureFormat.BC7_42)


def bytes_per_image(fmt: int, width: int, height: int) -> int:
    if fmt == TextureFormat.RGBA8:
        return width * height * 4
    bw, bh = (width + 3) // 4, (height + 3) // 4
    bpb = 8 if fmt == TextureFormat.BC1 else 16
    return bw * bh * bpb


class TextureFile:
    """Parsed .tex. Like the reference, exposes the first (top-mip) image."""

    def __init__(self, src):
        r = Reader(src)
        h = r.struct(HEADER_DTYPE)
        if bytes(h["magic"]) != TEX_MAGIC.rstrip(b"\0"):
            raise parse_error(f"bad texture magic {bytes(h['magic'])!r}", r.data, 0)

        bf4, bf8, bfc = int(h["bitfield_4"]), int(h["bitfield_8"]), int(h["bitfield_c"])
        self.version = bf4 & 0xFFFF
        self.attr = (bf4 >> 16) & 0xFF
        self.prebias = (bf4 >> 24) & 0xF
        self.image_type = TextureType((bf4 >> 28) & 0xF)
        self.level_count = bf8 & 0x3F
        self.width = ((bf8 >> 6) & 0x1FFF) << self.prebias
        self.height = ((bf8 >> 19) & 0x1FFF) << self.prebias
        self.array_count = bfc & 0xFF
        self.format = (bfc >> 8) & 0xFF
        self.depth = (bfc >> 16) & 0x1FFF

        if self.image_type != TextureType.TT_2D:
            raise ValueError(f"unsupported texture type {self.image_type!r}")

        log.debug("texture: v%d %dx%d fmt=%d levels=%d array=%d",
                  self.version, self.width, self.height, self.format,
                  self.level_count, self.array_count)
        num_images = self.array_count * self.level_count
        self.offsets = r.struct_array(np.dtype("<u8"), num_images).astype(np.int64)
        self._raw = r.data

        # first image = array slice 0, mip 0; reads to end like the reference
        # (rtexture.rs:126-130) but bounded by the next offset when known.
        self.data = self.image_bytes(0, 0)

    def image_bytes(self, level: int = 0, layer: int = 0) -> bytes:
        """Raw payload of one image (mip ``level`` of array ``layer``)."""
        idx = layer * self.level_count + level
        start = int(self.offsets[idx])
        if idx + 1 < len(self.offsets):
            return self._raw[start:int(self.offsets[idx + 1])]
        return self._raw[start:]

    def mip_size(self, level: int) -> tuple[int, int]:
        return max(1, self.width >> level), max(1, self.height >> level)

    def decode_rgba8(self) -> np.ndarray:
        """Decode the top image to an (H, W, 4) uint8 array on host
        (RGBA8; BCn formats raise until slice 4 ports their decoders)."""
        w, h, fmt = self.width, self.height, self.format
        if fmt == TextureFormat.RGBA8:
            n = w * h * 4
            return (
                np.frombuffer(self.data[:n], dtype=np.uint8)
                .reshape(h, w, 4)
                .copy()
            )
        if fmt in (TextureFormat.BC1, TextureFormat.BC7, TextureFormat.BC7_42):
            raise NotImplementedError(
                f"decoding texture format {fmt} is not ported yet: slice 4 "
                "(ROADMAP Queue 1 items 12-13)")
        raise ValueError(f"unhandled texture format {fmt}")


def write_texture(width: int, height: int, fmt: int, images: list[bytes],
                  levels: int = 1, layers: int = 1, prebias: int = 0) -> bytes:
    """Build a .tex byte stream (synthetic fixtures + tooling).

    ``images`` holds ``layers * levels`` payloads, layer-major.
    """
    assert len(images) == layers * levels
    assert width % (1 << prebias) == 0 and height % (1 << prebias) == 0

    h = np.zeros(1, dtype=HEADER_DTYPE)
    h[0]["magic"] = TEX_MAGIC
    h[0]["bitfield_4"] = (
        0x9D  # version seen in TGAAC-era files
        | (0 << 16)
        | ((prebias & 0xF) << 24)
        | (int(TextureType.TT_2D) << 28)
    )
    h[0]["bitfield_8"] = (
        (levels & 0x3F)
        | (((width >> prebias) & 0x1FFF) << 6)
        | (((height >> prebias) & 0x1FFF) << 19)
    )
    h[0]["bitfield_c"] = (layers & 0xFF) | ((fmt & 0xFF) << 8) | (1 << 16)

    header = h.tobytes()
    table_size = 8 * layers * levels
    offsets = []
    pos = len(header) + table_size
    for img in images:
        offsets.append(pos)
        pos += len(img)
    table = np.asarray(offsets, dtype="<u8").tobytes()
    return header + table + b"".join(images)
