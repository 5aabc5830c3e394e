"""Seeded BC1 and BC7 mip chains, for scene builders whose configuration
ships its textures block-compressed, as MT Framework's ``.tex`` assets
do.

A builder that calls these sets ``SceneArrays.chains`` (per texture, its
levels as ``(blocks (nb, k) u8, h, w)`` down to 1x1) and
``chain_format``; the program takes the blocks as an asset's chains and
the reference decodes them itself (``portbench/reference_bcn.py``).

What a configuration states under ``assumed`` for such textures: the
content is noise. Every block is drawn afresh from the run seed, at
every level, so every level differs from the next and a tap at the
wrong level, or a texel decoded wrong, shows in the frame. Its sizes
are the configuration's own.
"""

from __future__ import annotations

import numpy as np

from .. import reference_bcn

# per BC7 mode, the bits that opaque content fixes: (first bit of the
# alpha endpoints, their bits in all, rotation bits' first bit or None,
# p-bits' first bit or None, p-bits). The layout: the mode's m + 1
# prefix bits, partition, rotation, index selection, the colour
# endpoints (3 channels x endpoints x colour bits), the alpha endpoints,
# the p-bits, the indices.
_OPAQUE = {
    4: (38, 12, 5, None, 0),     # 5 + 2 + 1 + 3 x 2 x 5 = 38; 2 x 6 alpha
    5: (50, 16, 6, None, 0),     # 6 + 2 + 3 x 2 x 7 = 50; 2 x 8 alpha
    6: (49, 14, None, 63, 2),    # 7 + 3 x 2 x 7 = 49; 2 x 7 alpha; 2 p-bits
    7: (74, 20, None, 94, 4),    # 8 + 6 + 3 x 4 x 5 = 74; 4 x 5; 4 p-bits
}


def levels(size) -> list:
    """A texture's level sizes (h, w), each half the one before (at
    least 1), from ``size`` (an int for a square, or (h, w)) to 1x1."""
    h, w = (size, size) if np.ndim(size) == 0 else size
    out = [(int(h), int(w))]
    while out[-1] != (1, 1):
        out.append((max(1, out[-1][0] // 2), max(1, out[-1][1] // 2)))
    return out


def _nblocks(h: int, w: int) -> int:
    return -(-h // 4) * -(-w // 4)


def bc1_chain(rng, size) -> list:
    """A BC1 chain of a texture of ``size`` (see ``levels``): every
    block's 8 bytes drawn uniformly. Both colour modes occur, about half
    the blocks each: c0 > c1 (four opaque colours) and c0 <= c1 (three
    and a transparent black)."""
    return [(rng.integers(0, 256, (_nblocks(h, w), 8), dtype=np.uint8), h, w)
            for h, w in levels(size)]


def _set_bits(blocks: np.ndarray, start: int, count: int, value: int) -> None:
    """Set bits [start, start + count) of each of (n, 16) u8 blocks to
    ``value`` (0 or 1), bit 0 the lowest bit of byte 0."""
    for k in range(start, start + count):
        mask = np.uint8(1 << (k % 8))
        if value:
            blocks[:, k // 8] |= mask
        else:
            blocks[:, k // 8] &= ~mask


def bc7_blocks(rng, n: int, modes=tuple(range(8)),
               opaque: bool = True) -> np.ndarray:
    """(n, 16) u8 random BC7 blocks: each block's mode drawn uniformly from
    ``modes``, its prefix set, every other bit random (so every block is
    valid). With ``opaque``, every alpha endpoint takes its largest value
    and the p-bits of modes 6 and 7 are 1, so alpha decodes to 255; modes
    4 and 5 also take rotation 0, since a rotation swaps alpha with a
    colour channel."""
    blocks = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    mode = rng.choice(np.asarray(modes, np.int64), n)
    for m in set(int(x) for x in modes):
        pick = mode == m
        sub = blocks[pick]
        low = np.uint8((1 << (m + 1)) - 1)
        sub[:, 0] = (sub[:, 0] & ~low) | np.uint8(1 << m)
        if opaque and m in _OPAQUE:
            a0, na, rot, p0, npb = _OPAQUE[m]
            _set_bits(sub, a0, na, 1)
            if rot is not None:
                _set_bits(sub, rot, 2, 0)
            if p0 is not None:
                _set_bits(sub, p0, npb, 1)
        blocks[pick] = sub
    return blocks


def bc7_chain(rng, size, modes=tuple(range(8)),
              opaque: bool = True) -> list:
    """A BC7 chain of a texture of ``size`` (see ``levels``), every
    level's blocks from ``bc7_blocks``."""
    return [(bc7_blocks(rng, _nblocks(h, w), modes, opaque), h, w)
            for h, w in levels(size)]


def compress(arrays, fmt: str, rng, modes=tuple(range(8))):
    """``arrays`` with every texture shipped as a seeded ``fmt`` chain
    ("bc1", or "bc7" of ``modes``, opaque) at its own size: ``chains``
    and ``chain_format`` set, and ``textures`` each chain's level 0 as
    the reference decodes it. Returns ``arrays``."""
    if fmt == "bc7":
        chains = [bc7_chain(rng, t.shape[:2], modes) for t in arrays.textures]
    elif fmt == "bc1":
        chains = [bc1_chain(rng, t.shape[:2]) for t in arrays.textures]
    else:
        raise ValueError(f"unknown chain format {fmt!r}")
    decode = getattr(reference_bcn, f"decode_{fmt}")
    arrays.textures = [decode(*c[0]) for c in chains]
    arrays.chains, arrays.chain_format = chains, fmt
    return arrays
