"""The plain BC1 and BC7 decoders of the reference: compressed 4x4 blocks
→ RGBA8 texels.

Plain NumPy, importing nothing of the program, written from the format
specification (Microsoft's "Block Compression" and "BC7 Format"
documentation for Direct3D 11). Blocks are little-endian; the bits of a
BC7 block are read from bit 0 of byte 0 up. Each function takes one mip
level as ``(blocks (nb, k) u8, h, w)``, the blocks in row-major block
order, ``nb = ceil(h/4) ceil(w/4)``, and returns its (h, w, 4) u8 image
(a level under 4 texels wide or high keeps the top-left texels of its
blocks).

BC1's interpolated colours are given there as exact fractions of the
two endpoints (2/3 c0 + 1/3 c1, and 1/2 c0 + 1/2 c1 in the 3-colour
mode), with no rounding stated; Direct3D lets a decoder's result lie
within a tolerance of them. Here each is the exact value rounded to the
nearest integer on the 8-bit channels expanded from 5:6:5, a tie (only
the half can tie) going down: ``(2 a + b + 1) // 3`` and ``(a + b) // 2``.
Pillow's decoder, which rounds every fraction down, lies within 1 of
this on each channel and equals it in the 3-colour mode.
"""

from __future__ import annotations

import numpy as np


def _image(texels: np.ndarray, h: int, w: int) -> np.ndarray:
    """(nb, 16, 4) texels in block order → the level's (h, w, 4) u8."""
    bh, bw = -(-h // 4), -(-w // 4)
    img = texels.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(
        img.reshape(bh * 4, bw * 4, 4)[:h, :w]).astype(np.uint8)


def _blocks(blocks, k: int, h: int, w: int) -> np.ndarray:
    b = np.ascontiguousarray(blocks, np.uint8).reshape(-1, k)
    need = -(-h // 4) * -(-w // 4)
    if b.shape[0] != need:
        raise ValueError(f"{b.shape[0]} blocks for a {w}x{h} level "
                         f"({need} needed)")
    return b


# ------------------------------------------------------------------ BC1


def _expand565(c: np.ndarray) -> np.ndarray:
    """(n,) 16-bit 5:6:5 colours → (n, 3) int64 8-bit channels, each
    field's high bits copied into its low bits."""
    r, g, b = (c >> 11) & 31, (c >> 5) & 63, c & 31
    return np.stack([(r << 3) | (r >> 2), (g << 2) | (g >> 4),
                     (b << 3) | (b >> 2)], 1)


def decode_bc1(blocks, h: int, w: int) -> np.ndarray:
    """BC1 (8 B a block: colours c0, c1 as 5:6:5, then 16 2-bit indices,
    texel 0 in the lowest bits) → (h, w, 4) u8.

    Where c0 > c1 the block has four opaque colours: c0, c1, (2 c0 +
    c1) / 3 and (c0 + 2 c1) / 3. Otherwise three and a transparent black:
    c0, c1, (c0 + c1) / 2 and (0, 0, 0, 0)."""
    b = _blocks(blocks, 8, h, w).astype(np.int64)
    c0 = b[:, 0] | (b[:, 1] << 8)
    c1 = b[:, 2] | (b[:, 3] << 8)
    bits = b[:, 4] | (b[:, 5] << 8) | (b[:, 6] << 16) | (b[:, 7] << 24)
    e0, e1 = _expand565(c0), _expand565(c1)
    four = (c0 > c1)[:, None]
    opaque = np.full((len(b), 1), 255, np.int64)
    pal = np.stack([
        np.concatenate([e0, opaque], 1),
        np.concatenate([e1, opaque], 1),
        np.concatenate([np.where(four, (2 * e0 + e1 + 1) // 3,
                                 (e0 + e1) // 2), opaque], 1),
        np.where(four, np.concatenate([(e0 + 2 * e1 + 1) // 3, opaque], 1),
                 0),
    ], 1)                                               # (nb, 4, 4)
    idx = (bits[:, None] >> (2 * np.arange(16))) & 3    # (nb, 16)
    return _image(np.take_along_axis(pal, idx[..., None], 1), h, w)


# ------------------------------------------------------------------ BC7

# mode → (subsets, partition bits, rotation bits, index-selection bits,
#         colour bits, alpha bits, p-bits: "endpoint", "subset" or None,
#         index bits, secondary index bits)
MODES = {
    0: (3, 4, 0, 0, 4, 0, "endpoint", 3, 0),
    1: (2, 6, 0, 0, 6, 0, "subset", 3, 0),
    2: (3, 6, 0, 0, 5, 0, None, 2, 0),
    3: (2, 6, 0, 0, 7, 0, "endpoint", 2, 0),
    4: (1, 0, 2, 1, 5, 6, None, 2, 3),
    5: (1, 0, 2, 0, 7, 8, None, 2, 2),
    6: (1, 0, 0, 0, 7, 7, "endpoint", 4, 0),
    7: (2, 6, 0, 0, 5, 5, "endpoint", 2, 0),
}

# the interpolation weights of 2-, 3- and 4-bit indices
WEIGHTS = {
    2: (0, 21, 43, 64),
    3: (0, 9, 18, 27, 37, 46, 55, 64),
    4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64),
}

# the 64 two-subset partitions: each texel's subset, texel 0 first
PARTITIONS2 = """
0011001100110011 0001000100010001 0111011101110111 0001001100110111
0000000100010011 0011011101111111 0001001101111111 0000000100110111
0000000000010011 0011011111111111 0000000101111111 0000000000010111
0001011111111111 0000000011111111 0000111111111111 0000000000001111
0000100011101111 0111000100000000 0000000010001110 0111001100010000
0011000100000000 0000100011001110 0000000010001100 0111001100110001
0011000100010000 0000100010001100 0110011001100110 0011011001101100
0001011111101000 0000111111110000 0111000110001110 0011100110011100
0101010101010101 0000111100001111 0101101001011010 0011001111001100
0011110000111100 0101010110101010 0110100101101001 0101101010100101
0111001111001110 0001001111001000 0011001001001100 0011101111011100
0110100110010110 0011110011000011 0110011010011001 0000011001100000
0100111001000000 0010011100100000 0000001001110010 0000010011100100
0110110010010011 0011011011001001 0110001110011100 0011100111000110
0110110011001001 0110001100111001 0111111010000001 0001100011100111
0000111100110011 0011001111110000 0010001011101110 0100010001110111
"""

# the 64 three-subset partitions
PARTITIONS3 = """
0011001102212222 0001001122112221 0000200122112211 0222002200110111
0000000011221122 0011001100220022 0022002211111111 0011001122112211
0000000011112222 0000111111112222 0000111122222222 0012001200120012
0112011201120112 0122012201220122 0011011211221222 0011200122002220
0001001101121122 0111001120012200 0000112211221122 0022002200221111
0111011102220222 0001000122212221 0000001101220122 0000110022102210
0122012200110000 0012001211222222 0110122112210110 0000011012211221
0022110211020022 0110011020022222 0011012201220011 0000200022112221
0000000211221222 0222002200120011 0011001200220222 0120012001200120
0000111122220000 0120120120120120 0120201212010120 0011220011220011
0011112222000011 0101010122222222 0000000021212121 0022112200221122
0022001100220011 0220122102201221 0101222222220101 0000212121212121
0101010101012222 0222011102220111 0002111200021112 0000211221122112
0222011101110222 0002111211120002 0110011001102222 0000000021122112
0110011022222222 0022001100110022 0022112211220022 0000000000002112
0002000100020001 0222122202221222 0101222222222222 0111201122012220
"""

# the anchor texel of subset 1 of each two-subset partition (subset 0's
# is texel 0)
ANCHOR2 = (
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
    15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
    6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15)

# the anchor texels of subsets 1 and 2 of each three-subset partition
ANCHOR3_1 = (
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
    3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
    8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
    3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3)
ANCHOR3_2 = (
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
    15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
    15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
    15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8)


def _table(text: str) -> np.ndarray:
    rows = text.split()
    return np.array([[int(c) for c in r] for r in rows], np.int64)


_SUBSETS = {2: _table(PARTITIONS2), 3: _table(PARTITIONS3)}


def _anchors(nsub: int, part: np.ndarray) -> np.ndarray:
    """(n,) partition numbers → (n, nsub) anchor texels, subset 0's 0."""
    cols = [np.zeros_like(part)]
    if nsub == 2:
        cols.append(np.asarray(ANCHOR2, np.int64)[part])
    elif nsub == 3:
        cols += [np.asarray(ANCHOR3_1, np.int64)[part],
                 np.asarray(ANCHOR3_2, np.int64)[part]]
    return np.stack(cols, 1)


class _Bits:
    """The 128 bits of each of (n, 16) u8 blocks, read in order from bit
    0 of byte 0."""

    def __init__(self, blocks: np.ndarray):
        self.bits = np.unpackbits(blocks, axis=1, bitorder="little"
                                  ).astype(np.int64)        # (n, 128)
        self.pos = 0

    def take(self, count: int) -> np.ndarray:
        """The next ``count`` bits of every block, as (n,) integers."""
        v = np.zeros(self.bits.shape[0], np.int64)
        for k in range(count):
            v |= self.bits[:, self.pos + k] << k
        self.pos += count
        return v

    def at(self, start: np.ndarray, count: np.ndarray) -> np.ndarray:
        """(n,) integers of ``count`` (n,) bits from bit ``start`` (n,)."""
        v = np.zeros(self.bits.shape[0], np.int64)
        rows = np.arange(self.bits.shape[0])
        for k in range(int(count.max(initial=0))):
            on = k < count
            v |= np.where(on, self.bits[rows, np.minimum(start + k, 127)],
                          0) << k
        return v


def _unquantize(v: np.ndarray, bits: int) -> np.ndarray:
    """A ``bits``-bit endpoint channel (its p-bit appended already) → 8
    bits: shifted to the top and its high bits copied into the low."""
    v = v << (8 - bits)
    return v | (v >> bits)


def _decode_mode(blocks: np.ndarray, mode: int) -> np.ndarray:
    """(n, 16) u8 blocks, all of ``mode`` → (n, 16, 4) int64 texels."""
    nsub, pb, rb, isb, cb, ab, pbits, ib, ib2 = MODES[mode]
    n = blocks.shape[0]
    r = _Bits(blocks)
    r.take(mode + 1)                            # mode + 1 bits: 0...01
    part = r.take(pb)
    rotation = r.take(rb)
    selection = r.take(isb)
    # endpoints: channel by channel (r, g, b, then a), and in each
    # channel subset by subset, e0 then e1
    neps = 2 * nsub
    ep = np.zeros((n, neps, 4), np.int64)
    for c in range(4 if ab else 3):
        for e in range(neps):
            ep[:, e, c] = r.take(cb if c < 3 else ab)
    bits_c, bits_a = cb, ab
    if pbits == "endpoint":
        p = np.stack([r.take(1) for _ in range(neps)], 1)
    elif pbits == "subset":
        p = np.repeat(np.stack([r.take(1) for _ in range(nsub)], 1), 2, 1)
    if pbits is not None:
        ep = (ep << 1) | p[..., None]
        bits_c, bits_a = cb + 1, ab + 1 if ab else 0
    ep[..., :3] = _unquantize(ep[..., :3], bits_c)
    if ab:
        ep[..., 3] = _unquantize(ep[..., 3], bits_a)
    else:
        ep[..., 3] = 255

    # each texel's subset; anchors' indices have one bit less
    texel = np.arange(16)
    if nsub == 1:
        subset = np.zeros((n, 16), np.int64)
    else:
        subset = _SUBSETS[nsub][part]
    anchors = _anchors(nsub, part)                      # (n, nsub)
    is_anchor = (texel[None, :, None] == anchors[:, None, :]).any(2)

    def indices(width: int, anchor: np.ndarray) -> np.ndarray:
        """(n, 16) indices of ``width`` bits, one bit less where
        ``anchor``, texel 0 first, from the reader's position on."""
        size = width - anchor.astype(np.int64)
        start = r.pos + np.cumsum(size, 1) - size
        out = np.stack([r.at(start[:, t], size[:, t]) for t in range(16)],
                       1)
        r.pos += int(size[0].sum())
        return out

    idx = indices(ib, is_anchor)
    idx2 = (indices(ib2, np.broadcast_to(texel == 0, (n, 16))) if ib2
            else None)
    if r.pos != 128:
        raise AssertionError(f"mode {mode}: {r.pos} bits read, not 128")

    w_col = np.asarray(WEIGHTS[ib], np.int64)[idx]
    w_alp = w_col
    if mode == 4:                   # the selection bit swaps the two sets
        w2 = np.asarray(WEIGHTS[ib2], np.int64)[idx2]
        sel = selection[:, None] == 1
        w_col, w_alp = np.where(sel, w2, w_col), np.where(sel, w_col, w2)
    elif mode == 5:
        w_alp = np.asarray(WEIGHTS[ib2], np.int64)[idx2]

    e0 = np.take_along_axis(ep, (2 * subset)[..., None], 1)       # (n, 16, 4)
    e1 = np.take_along_axis(ep, (2 * subset + 1)[..., None], 1)
    wgt = np.concatenate([np.repeat(w_col[..., None], 3, 2),
                          w_alp[..., None]], 2)
    out = (e0 * (64 - wgt) + e1 * wgt + 32) >> 6
    # rotation 1, 2, 3 swaps alpha with red, green, blue
    for rot in (1, 2, 3):
        m = rotation == rot
        out[m, :, rot - 1], out[m, :, 3] = (out[m, :, 3].copy(),
                                            out[m, :, rot - 1].copy())
    return out


def decode_bc7(blocks, h: int, w: int) -> np.ndarray:
    """BC7 (16 B a block, in eight modes) → (h, w, 4) u8.

    A block's mode is the number of zero bits below the first set bit of
    byte 0. Then, as the mode lays out: the partition (which subset each
    texel belongs to, from the 64-entry two- and three-subset tables),
    the rotation and the index selection; the endpoints, colour channels
    then alpha, each quantised and extended by its p-bit where the mode
    has them (one an endpoint, or one a subset); the indices, texel 0
    first, each anchor texel's one bit short. A texel is ``(e0 (64 - w)
    + e1 w + 32) >> 6`` of its subset's endpoints at its index's weight,
    then rotated. Modes 0-3 carry no alpha and decode it as 255. A block
    whose byte 0 is 0 (the reserved mode) decodes to zeros in every
    channel."""
    b = _blocks(blocks, 16, h, w)
    low = b[:, 0].astype(np.int64)
    mode = np.full(len(b), -1, np.int64)
    for m in range(7, -1, -1):
        mode = np.where((low >> m) & 1 == 1, m, mode)
    out = np.zeros((len(b), 16, 4), np.int64)
    for m in range(8):
        pick = mode == m
        if pick.any():
            out[pick] = _decode_mode(b[pick], m)
    return _image(out, h, w)
