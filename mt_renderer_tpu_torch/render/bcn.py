"""BC1 and BC7 block-compressed texture decoding and encoding.

The port's copy of ``mt_renderer_tpu/render/bcn.py``: the NumPy
functions are copies of the reference's, under its names;
``decode_bc1_device``, ``decode_bc7_device`` and ``bc7_texel_device``
(the bc7 pool's sample-time decode) are its device decodes as integer
torch ops on an explicit device.

BC1 (DXT1): 8-byte blocks of two RGB565 endpoints and 32 2-bit indices,
the palette's interpolants ``(2a + b + 1) // 3`` (four-color blocks,
c0 > c1) or ``(a + b) // 2`` and transparent black (three-color,
punch-through blocks), per the public BC1 specification.

BC7: 16-byte blocks in eight modes (1-3 subsets over the spec's 64
partition shapes, 4-8 bit endpoint channels, p-bits, 2-4 bit indices, a
rotation and an index selection in modes 4 and 5), interpolated as
``(a * (64 - w) + b * w + 32) >> 6``, per the public BC7 specification.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# BC1 (DXT1): 8-byte blocks: 2x RGB565 endpoints + 32x 2-bit indices
# ---------------------------------------------------------------------------


def _rgb565_to_rgb888(c):
    r = (c >> 11) & 0x1F
    g = (c >> 5) & 0x3F
    b = c & 0x1F
    r = (r << 3) | (r >> 2)
    g = (g << 2) | (g >> 4)
    b = (b << 3) | (b >> 2)
    return r, g, b


def decode_bc1_numpy(data, width: int, height: int) -> np.ndarray:
    """Decode BC1 blocks to (height, width, 4) uint8."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    n = bw * bh
    blocks = np.frombuffer(data, dtype="<u2", count=n * 4).reshape(n, 4)
    c0 = blocks[:, 0].astype(np.uint32)
    c1 = blocks[:, 1].astype(np.uint32)
    bits = (blocks[:, 2].astype(np.uint32)
            | (blocks[:, 3].astype(np.uint32) << 16))

    r0, g0, b0 = _rgb565_to_rgb888(c0)
    r1, g1, b1 = _rgb565_to_rgb888(c1)

    # palette (n, 4, 4) rgba
    pal = np.zeros((n, 4, 4), dtype=np.uint16)
    pal[:, 0] = np.stack([r0, g0, b0, np.full(n, 255)], axis=-1)
    pal[:, 1] = np.stack([r1, g1, b1, np.full(n, 255)], axis=-1)

    four_color = c0 > c1
    # 4-color: c2 = (2*c0 + c1)/3, c3 = (c0 + 2*c1)/3 with alpha 255
    c2_4 = np.stack([(2 * r0 + r1 + 1) // 3, (2 * g0 + g1 + 1) // 3,
                     (2 * b0 + b1 + 1) // 3, np.full(n, 255)], axis=-1)
    c3_4 = np.stack([(r0 + 2 * r1 + 1) // 3, (g0 + 2 * g1 + 1) // 3,
                     (b0 + 2 * b1 + 1) // 3, np.full(n, 255)], axis=-1)
    # 3-color: c2 = (c0+c1)/2, c3 = transparent black
    c2_3 = np.stack([(r0 + r1) // 2, (g0 + g1) // 2,
                     (b0 + b1) // 2, np.full(n, 255)], axis=-1)
    c3_3 = np.zeros((n, 4), dtype=np.uint16)

    fc = four_color[:, None]
    pal[:, 2] = np.where(fc, c2_4, c2_3)
    pal[:, 3] = np.where(fc, c3_4, c3_3)

    texel = np.arange(16, dtype=np.uint32)
    idx = (bits[:, None] >> (2 * texel)[None, :]) & 0x3          # (n, 16)
    texels = np.take_along_axis(pal, idx[..., None].astype(np.intp), axis=1)

    img = texels.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    img = img.reshape(bh * 4, bw * 4, 4)[:height, :width]
    return img.astype(np.uint8)


# ---------------------------------------------------------------------------
# BC1 encode — the compressed-resident texel pool's content pipeline
# ---------------------------------------------------------------------------


def encode_bc1_numpy(img: np.ndarray) -> np.ndarray:
    """Encode (h, w, 4) uint8 RGBA → (bh·bw, 8) uint8 BC1 blocks in
    raster block order (little-endian words, the on-disk layout
    ``decode_bc1_numpy`` reads).

    The content pipeline of ``device.upload(pool_mode="bc1")``: blocks
    stay resident and decode at sample time, so encode quality is a
    content decision (the renderer is exact with respect to the blocks).
    Fast bounding-box fit: endpoints are the per-channel min/max corners
    quantised to 565, indices the nearest decoded palette entry
    (self-consistent with the decoder's integer interpolation by
    construction). Alpha < 128 → the three-color punch-through mode
    (``c0 <= c1``) with index 3, the BC1 specification's 1-bit alpha.
    """
    h, w = img.shape[:2]
    bh, bw = (h + 3) // 4, (w + 3) // 4
    yi = np.minimum(np.arange(bh * 4), h - 1)
    xi = np.minimum(np.arange(bw * 4), w - 1)
    p = img[yi][:, xi]                       # edge-replicated pad
    blocks = p.reshape(bh, 4, bw, 4, 4).transpose(0, 2, 1, 3, 4)
    blocks = blocks.reshape(-1, 16, 4)
    n = blocks.shape[0]
    rgb = blocks[..., :3].astype(np.int32)   # (n, 16, 3)
    transp = blocks[..., 3] < 128            # (n, 16)
    has_t = transp.any(axis=1)
    opq = ~transp
    any_opq = opq.any(axis=1)
    lo = np.where(any_opq[:, None],
                  np.where(opq[..., None], rgb, 255).min(axis=1), 0)
    hi = np.where(any_opq[:, None],
                  np.where(opq[..., None], rgb, 0).max(axis=1), 0)

    def q565(c):                             # (n, 3) -> (n,) u16 value
        r = (c[:, 0] * 31 + 127) // 255
        g = (c[:, 1] * 63 + 127) // 255
        b = (c[:, 2] * 31 + 127) // 255
        return ((r << 11) | (g << 5) | b).astype(np.int32)

    chi, clo = q565(hi), q565(lo)
    # opaque blocks want the 4-color mode (c0 > c1); punch-through
    # blocks NEED c0 <= c1; equal endpoints decode as 3-color with
    # index 0 either way
    c0 = np.where(has_t, np.minimum(chi, clo), np.maximum(chi, clo))
    c1 = np.where(has_t, np.maximum(chi, clo), np.minimum(chi, clo))

    # decoded palette, exactly the decoder's arithmetic
    r0, g0, b0 = _rgb565_to_rgb888(c0.astype(np.uint32))
    r1, g1, b1 = _rgb565_to_rgb888(c1.astype(np.uint32))
    e0 = np.stack([r0, g0, b0], axis=-1).astype(np.int32)  # (n, 3)
    e1 = np.stack([r1, g1, b1], axis=-1).astype(np.int32)
    four = (c0 > c1)[:, None]
    p2 = np.where(four, (2 * e0 + e1 + 1) // 3, (e0 + e1) // 2)
    p3 = np.where(four, (e0 + 2 * e1 + 1) // 3, 0)
    pal = np.stack([e0, e1, p2, p3], axis=1)               # (n, 4, 3)
    # nearest usable entry: 4-color uses all four; 3-color keeps
    # opaque texels out of the transparent slot 3
    d = ((rgb[:, :, None, :] - pal[:, None, :, :]) ** 2).sum(-1)
    usable3 = ~four[:, None] & has_t[:, None, None] \
        & (np.arange(4) == 3)[None, None, :]
    d = np.where(usable3, np.int64(1) << 40, d)            # (n, 16, 4)
    idx = d.argmin(axis=2).astype(np.uint32)
    idx = np.where(transp & has_t[:, None], np.uint32(3), idx)

    bits = np.zeros(n, np.uint32)
    for t in range(16):
        bits |= idx[:, t] << np.uint32(2 * t)
    out = np.empty((n, 8), np.uint8)
    out[:, 0] = c0 & 0xFF
    out[:, 1] = c0 >> 8
    out[:, 2] = c1 & 0xFF
    out[:, 3] = c1 >> 8
    for i in range(4):
        out[:, 4 + i] = (bits >> np.uint32(8 * i)) & 0xFF
    return out


def decode_bc1_blocks_numpy(blocks: np.ndarray, width: int,
                            height: int) -> np.ndarray:
    """(bh·bw, 8) uint8 blocks → (height, width, 4) uint8 (the array
    twin of ``decode_bc1_numpy``'s bytes interface)."""
    return decode_bc1_numpy(np.ascontiguousarray(blocks).tobytes(),
                            width, height)


# ---------------------------------------------------------------------------
# reference scalar decoder (the oracle for the vectorized paths' tests)
# ---------------------------------------------------------------------------


def decode_bc1_block_scalar(block: bytes):
    """Decode one 8-byte BC1 block to a (4, 4, 4) uint8 array (test oracle)."""
    c0 = block[0] | (block[1] << 8)
    c1 = block[2] | (block[3] << 8)
    bits = int.from_bytes(block[4:8], "little")

    def expand(c):
        r, g, b = (c >> 11) & 0x1F, (c >> 5) & 0x3F, c & 0x1F
        return ((r << 3) | (r >> 2), (g << 2) | (g >> 4), (b << 3) | (b >> 2))

    p0, p1 = expand(c0), expand(c1)
    pal = [(*p0, 255), (*p1, 255)]
    if c0 > c1:
        pal.append(tuple((2 * a + b + 1) // 3 for a, b in zip(p0, p1)) + (255,))
        pal.append(tuple((a + 2 * b + 1) // 3 for a, b in zip(p0, p1)) + (255,))
    else:
        pal.append(tuple((a + b) // 2 for a, b in zip(p0, p1)) + (255,))
        pal.append((0, 0, 0, 0))

    out = np.zeros((4, 4, 4), dtype=np.uint8)
    for t in range(16):
        out[t // 4, t % 4] = pal[(bits >> (2 * t)) & 3]
    return out


# ---------------------------------------------------------------------------
# on-device BC1 decode — load-time decode without a host round trip
# ---------------------------------------------------------------------------


def _div3(x):
    """Floor division by 3 of a non-negative int tensor (the
    interpolants' ``//``; floor and truncation agree on these operands,
    the rounding mode is spelled out anyway)."""
    return torch.div(x, 3, rounding_mode="floor")


def decode_bc1_device(data, width: int, height: int, *,
                      device=None) -> torch.Tensor:
    """Decode BC1 blocks to a (height, width, 4) uint8 tensor.

    ``data``: the raw block bytes, a uint8 tensor (decoded on its own
    device unless ``device`` names another) or a bytes-like object or
    NumPy array (then ``device`` is required). The same integer
    arithmetic as ``decode_bc1_numpy``, in int32 lanes; the 32-bit index
    word is held in int64, so its shifts stay logical with bit 31 set."""
    if isinstance(data, torch.Tensor):
        raw = data.to(device if device is not None else data.device)
    else:
        if device is None:
            raise ValueError("decode_bc1_device needs a device for "
                             "host data")
        host = (np.frombuffer(bytes(data), np.uint8)
                if isinstance(data, (bytes, bytearray, memoryview))
                else np.asarray(data, np.uint8))
        raw = torch.tensor(host, device=device)
    bw, bh = (width + 3) // 4, (height + 3) // 4
    n = bw * bh
    raw = raw.reshape(-1)[: n * 8].reshape(n, 8)
    u = raw.to(torch.int32)
    c0 = u[:, 0] | (u[:, 1] << 8)
    c1 = u[:, 2] | (u[:, 3] << 8)
    u64 = raw.to(torch.int64)
    bits = u64[:, 4] | (u64[:, 5] << 8) | (u64[:, 6] << 16) | (u64[:, 7] << 24)

    r0, g0, b0 = _rgb565_to_rgb888(c0)
    r1, g1, b1 = _rgb565_to_rgb888(c1)
    full = torch.full_like(c0, 255)

    def rgba(r, g, b, a):
        return torch.stack([r, g, b, a], -1)              # (n, 4)

    four = (c0 > c1)[:, None]
    p0 = rgba(r0, g0, b0, full)
    p1 = rgba(r1, g1, b1, full)
    p2 = torch.where(
        four,
        rgba(_div3(2 * r0 + r1 + 1), _div3(2 * g0 + g1 + 1),
             _div3(2 * b0 + b1 + 1), full),
        rgba((r0 + r1) >> 1, (g0 + g1) >> 1, (b0 + b1) >> 1, full))
    p3 = torch.where(
        four,
        rgba(_div3(r0 + 2 * r1 + 1), _div3(g0 + 2 * g1 + 1),
             _div3(b0 + 2 * b1 + 1), full),
        torch.zeros_like(p0))
    pal = torch.stack([p0, p1, p2, p3], 1)                # (n, 4, 4)

    texel = 2 * torch.arange(16, dtype=torch.int64, device=raw.device)
    idx = (bits[:, None] >> texel[None, :]) & 3           # (n, 16)
    texels = torch.gather(pal, 1, idx[..., None].expand(n, 16, 4))

    img = texels.reshape(bh, bw, 4, 4, 4).permute(0, 2, 1, 3, 4)
    img = img.reshape(bh * 4, bw * 4, 4)[:height, :width]
    return img.to(torch.uint8).contiguous()


# ---------------------------------------------------------------------------
# BC7: 16-byte blocks, 8 modes
# ---------------------------------------------------------------------------

# Subset assignment tables from the BC7 specification (64 partition shapes
# for 2 and 3 subsets), texels in raster order within the 4x4 block.
_P2 = np.array([
    [0,0,1,1,0,0,1,1,0,0,1,1,0,0,1,1],[0,0,0,1,0,0,0,1,0,0,0,1,0,0,0,1],
    [0,1,1,1,0,1,1,1,0,1,1,1,0,1,1,1],[0,0,0,1,0,0,1,1,0,0,1,1,0,1,1,1],
    [0,0,0,0,0,0,0,1,0,0,0,1,0,0,1,1],[0,0,1,1,0,1,1,1,0,1,1,1,1,1,1,1],
    [0,0,0,1,0,0,1,1,0,1,1,1,1,1,1,1],[0,0,0,0,0,0,0,1,0,0,1,1,0,1,1,1],
    [0,0,0,0,0,0,0,0,0,0,0,1,0,0,1,1],[0,0,1,1,0,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,0,1,0,1,1,1,1,1,1,1],[0,0,0,0,0,0,0,0,0,0,0,1,0,1,1,1],
    [0,0,0,1,0,1,1,1,1,1,1,1,1,1,1,1],[0,0,0,0,0,0,0,0,1,1,1,1,1,1,1,1],
    [0,0,0,0,1,1,1,1,1,1,1,1,1,1,1,1],[0,0,0,0,0,0,0,0,0,0,0,0,1,1,1,1],
    [0,0,0,0,1,0,0,0,1,1,1,0,1,1,1,1],[0,1,1,1,0,0,0,1,0,0,0,0,0,0,0,0],
    [0,0,0,0,0,0,0,0,1,0,0,0,1,1,1,0],[0,1,1,1,0,0,1,1,0,0,0,1,0,0,0,0],
    [0,0,1,1,0,0,0,1,0,0,0,0,0,0,0,0],[0,0,0,0,1,0,0,0,1,1,0,0,1,1,1,0],
    [0,0,0,0,0,0,0,0,1,0,0,0,1,1,0,0],[0,1,1,1,0,0,1,1,0,0,1,1,0,0,0,1],
    [0,0,1,1,0,0,0,1,0,0,0,1,0,0,0,0],[0,0,0,0,1,0,0,0,1,0,0,0,1,1,0,0],
    [0,1,1,0,0,1,1,0,0,1,1,0,0,1,1,0],[0,0,1,1,0,1,1,0,0,1,1,0,1,1,0,0],
    [0,0,0,1,0,1,1,1,1,1,1,0,1,0,0,0],[0,0,0,0,1,1,1,1,1,1,1,1,0,0,0,0],
    [0,1,1,1,0,0,0,1,1,0,0,0,1,1,1,0],[0,0,1,1,1,0,0,1,1,0,0,1,1,1,0,0],
    [0,1,0,1,0,1,0,1,0,1,0,1,0,1,0,1],[0,0,0,0,1,1,1,1,0,0,0,0,1,1,1,1],
    [0,1,0,1,1,0,1,0,0,1,0,1,1,0,1,0],[0,0,1,1,0,0,1,1,1,1,0,0,1,1,0,0],
    [0,0,1,1,1,1,0,0,0,0,1,1,1,1,0,0],[0,1,0,1,0,1,0,1,1,0,1,0,1,0,1,0],
    [0,1,1,0,1,0,0,1,0,1,1,0,1,0,0,1],[0,1,0,1,1,0,1,0,1,0,1,0,0,1,0,1],
    [0,1,1,1,0,0,1,1,1,1,0,0,1,1,1,0],[0,0,0,1,0,0,1,1,1,1,0,0,1,0,0,0],
    [0,0,1,1,0,0,1,0,0,1,0,0,1,1,0,0],[0,0,1,1,1,0,1,1,1,1,0,1,1,1,0,0],
    [0,1,1,0,1,0,0,1,1,0,0,1,0,1,1,0],[0,0,1,1,1,1,0,0,1,1,0,0,0,0,1,1],
    [0,1,1,0,0,1,1,0,1,0,0,1,1,0,0,1],[0,0,0,0,0,1,1,0,0,1,1,0,0,0,0,0],
    [0,1,0,0,1,1,1,0,0,1,0,0,0,0,0,0],[0,0,1,0,0,1,1,1,0,0,1,0,0,0,0,0],
    [0,0,0,0,0,0,1,0,0,1,1,1,0,0,1,0],[0,0,0,0,0,1,0,0,1,1,1,0,0,1,0,0],
    [0,1,1,0,1,1,0,0,1,0,0,1,0,0,1,1],[0,0,1,1,0,1,1,0,1,1,0,0,1,0,0,1],
    [0,1,1,0,0,0,1,1,1,0,0,1,1,1,0,0],[0,0,1,1,1,0,0,1,1,1,0,0,0,1,1,0],
    [0,1,1,0,1,1,0,0,1,1,0,0,1,0,0,1],[0,1,1,0,0,0,1,1,0,0,1,1,1,0,0,1],
    [0,1,1,1,1,1,1,0,1,0,0,0,0,0,0,1],[0,0,0,1,1,0,0,0,1,1,1,0,0,1,1,1],
    [0,0,0,0,1,1,1,1,0,0,1,1,0,0,1,1],[0,0,1,1,0,0,1,1,1,1,1,1,0,0,0,0],
    [0,0,1,0,0,0,1,0,1,1,1,0,1,1,1,0],[0,1,0,0,0,1,0,0,0,1,1,1,0,1,1,1],
], dtype=np.uint8)

_P3 = np.array([
    [0,0,1,1,0,0,1,1,0,2,2,1,2,2,2,2],[0,0,0,1,0,0,1,1,2,2,1,1,2,2,2,1],
    [0,0,0,0,2,0,0,1,2,2,1,1,2,2,1,1],[0,2,2,2,0,0,2,2,0,0,1,1,0,1,1,1],
    [0,0,0,0,0,0,0,0,1,1,2,2,1,1,2,2],[0,0,1,1,0,0,1,1,0,0,2,2,0,0,2,2],
    [0,0,2,2,0,0,2,2,1,1,1,1,1,1,1,1],[0,0,1,1,0,0,1,1,2,2,1,1,2,2,1,1],
    [0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2],[0,0,0,0,1,1,1,1,1,1,1,1,2,2,2,2],
    [0,0,0,0,1,1,1,1,2,2,2,2,2,2,2,2],[0,0,1,2,0,0,1,2,0,0,1,2,0,0,1,2],
    [0,1,1,2,0,1,1,2,0,1,1,2,0,1,1,2],[0,1,2,2,0,1,2,2,0,1,2,2,0,1,2,2],
    [0,0,1,1,0,1,1,2,1,1,2,2,1,2,2,2],[0,0,1,1,2,0,0,1,2,2,0,0,2,2,2,0],
    [0,0,0,1,0,0,1,1,0,1,1,2,1,1,2,2],[0,1,1,1,0,0,1,1,2,0,0,1,2,2,0,0],
    [0,0,0,0,1,1,2,2,1,1,2,2,1,1,2,2],[0,0,2,2,0,0,2,2,0,0,2,2,1,1,1,1],
    [0,1,1,1,0,1,1,1,0,2,2,2,0,2,2,2],[0,0,0,1,0,0,0,1,2,2,2,1,2,2,2,1],
    [0,0,0,0,0,0,1,1,0,1,2,2,0,1,2,2],[0,0,0,0,1,1,0,0,2,2,1,0,2,2,1,0],
    [0,1,2,2,0,1,2,2,0,0,1,1,0,0,0,0],[0,0,1,2,0,0,1,2,1,1,2,2,2,2,2,2],
    [0,1,1,0,1,2,2,1,1,2,2,1,0,1,1,0],[0,0,0,0,0,1,1,0,1,2,2,1,1,2,2,1],
    [0,0,2,2,1,1,0,2,1,1,0,2,0,0,2,2],[0,1,1,0,0,1,1,0,2,0,0,2,2,2,2,2],
    [0,0,1,1,0,1,2,2,0,1,2,2,0,0,1,1],[0,0,0,0,2,0,0,0,2,2,1,1,2,2,2,1],
    [0,0,0,0,0,0,0,2,1,1,2,2,1,2,2,2],[0,2,2,2,0,0,2,2,0,0,1,2,0,0,1,1],
    [0,0,1,1,0,0,1,2,0,0,2,2,0,2,2,2],[0,1,2,0,0,1,2,0,0,1,2,0,0,1,2,0],
    [0,0,0,0,1,1,1,1,2,2,2,2,0,0,0,0],[0,1,2,0,1,2,0,1,2,0,1,2,0,1,2,0],
    [0,1,2,0,2,0,1,2,1,2,0,1,0,1,2,0],[0,0,1,1,2,2,0,0,1,1,2,2,0,0,1,1],
    [0,0,1,1,1,1,2,2,2,2,0,0,0,0,1,1],[0,1,0,1,0,1,0,1,2,2,2,2,2,2,2,2],
    [0,0,0,0,0,0,0,0,2,1,2,1,2,1,2,1],[0,0,2,2,1,1,2,2,0,0,2,2,1,1,2,2],
    [0,0,2,2,0,0,1,1,0,0,2,2,0,0,1,1],[0,2,2,0,1,2,2,1,0,2,2,0,1,2,2,1],
    [0,1,0,1,2,2,2,2,2,2,2,2,0,1,0,1],[0,0,0,0,2,1,2,1,2,1,2,1,2,1,2,1],
    [0,1,0,1,0,1,0,1,0,1,0,1,2,2,2,2],[0,2,2,2,0,1,1,1,0,2,2,2,0,1,1,1],
    [0,0,0,2,1,1,1,2,0,0,0,2,1,1,1,2],[0,0,0,0,2,1,1,2,2,1,1,2,2,1,1,2],
    [0,2,2,2,0,1,1,1,0,1,1,1,0,2,2,2],[0,0,0,2,1,1,1,2,1,1,1,2,0,0,0,2],
    [0,1,1,0,0,1,1,0,0,1,1,0,2,2,2,2],[0,0,0,0,0,0,0,0,2,1,1,2,2,1,1,2],
    [0,1,1,0,0,1,1,0,2,2,2,2,2,2,2,2],[0,0,2,2,0,0,1,1,0,0,1,1,0,0,2,2],
    [0,0,2,2,1,1,2,2,1,1,2,2,0,0,2,2],[0,0,0,0,0,0,0,0,0,0,0,0,2,1,1,2],
    [0,0,0,2,0,0,0,1,0,0,0,2,0,0,0,1],[0,2,2,2,1,2,2,2,0,2,2,2,1,2,2,2],
    [0,1,0,1,2,2,2,2,2,2,2,2,2,2,2,2],[0,1,1,1,2,0,1,1,2,2,0,1,2,2,2,0],
], dtype=np.uint8)

# Anchor texel index of subset 1 (2-subset modes) / subsets 1 and 2
# (3-subset modes), per partition shape. Subset 0's anchor is texel 0.
_ANCHOR2_1 = np.array([
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
    15, 2, 8, 2, 2, 8, 8,15, 2, 8, 2, 2, 8, 8, 2, 2,
    15,15, 6, 8, 2, 8,15,15, 2, 8, 2, 2, 2,15,15, 6,
     6, 2, 6, 8,15,15, 2, 2,15,15,15,15,15, 2, 2,15,
], dtype=np.uint8)
_ANCHOR3_1 = np.array([
     3, 3,15,15, 8, 3,15,15, 8, 8, 6, 6, 6, 5, 3, 3,
     3, 3, 8,15, 3, 3, 6,10, 5, 8, 8, 6, 8, 5,15,15,
     8,15, 3, 5, 6,10, 8,15,15, 3,15, 5,15,15,15,15,
     3,15, 5, 5, 5, 8, 5,10, 5,10, 8,13,15,12, 3, 3,
], dtype=np.uint8)
_ANCHOR3_2 = np.array([
    15, 8, 8, 3,15,15, 3, 8,15,15,15,15,15,15,15, 8,
    15, 8,15, 3,15, 8,15, 8, 3,15, 6,10,15,15,10, 8,
    15, 3,15,10,10, 8, 9,10, 6,15, 8,15, 3, 6, 6, 8,
    15, 3,15,15,15,15,15,15,15,15,15,15, 3,15,15, 8,
], dtype=np.uint8)

_WEIGHTS = {
    2: np.array([0, 21, 43, 64], dtype=np.uint16),
    3: np.array([0, 9, 18, 27, 37, 46, 55, 64], dtype=np.uint16),
    4: np.array([0, 4, 9, 13, 17, 21, 26, 30,
                 34, 38, 43, 47, 51, 55, 60, 64], dtype=np.uint16),
}

# mode -> (subsets, partition_bits, rotation_bits, index_sel_bits,
#          color_bits, alpha_bits, pbits_per_block, shared_pbits,
#          index_bits, index2_bits)
_MODES = {
    0: (3, 4, 0, 0, 4, 0, 6, False, 3, 0),
    1: (2, 6, 0, 0, 6, 0, 2, True, 3, 0),
    2: (3, 6, 0, 0, 5, 0, 0, False, 2, 0),
    3: (2, 6, 0, 0, 7, 0, 4, False, 2, 0),
    4: (1, 0, 2, 1, 5, 6, 0, False, 2, 3),
    5: (1, 0, 2, 0, 7, 8, 0, False, 2, 2),
    6: (1, 0, 0, 0, 7, 7, 2, False, 4, 0),
    7: (2, 6, 0, 0, 5, 5, 4, False, 2, 0),
}


def _get_bits(lo, hi, start, count):
    """Extract ``count`` bits at ``start`` from 128-bit (lo, hi) pairs."""
    if count == 0:
        return np.zeros_like(lo, dtype=np.uint64)
    mask = np.uint64((1 << count) - 1)
    s = int(start)
    if s + count <= 64:
        return (lo >> np.uint64(s)) & mask
    if s >= 64:
        return (hi >> np.uint64(s - 64)) & mask
    lo_part = lo >> np.uint64(s)
    hi_part = hi << np.uint64(64 - s)
    return (lo_part | hi_part) & mask


def _unquantize(ep, bits, pbit=None):
    """Expand a b-bit endpoint channel (optionally with p-bit) to 8 bits."""
    ep = ep.astype(np.uint32)
    if pbit is not None:
        ep = (ep << 1) | pbit.astype(np.uint32)
        bits = bits + 1
    ep = ep << (8 - bits)
    return ep | (ep >> bits)


def _decode_mode_group(lo, hi, mode):
    """Decode all blocks of one mode. Returns (n, 16, 4) uint8 texels."""
    (nsub, pbits_n, rot_n, isb_n, cb, ab, npb, shared_pb, ib, ib2) = _MODES[mode]
    n = lo.shape[0]
    pos = mode + 1  # mode prefix: `mode` zeros then a 1

    partition = _get_bits(lo, hi, pos, pbits_n).astype(np.intp); pos += pbits_n
    rotation = _get_bits(lo, hi, pos, rot_n).astype(np.intp); pos += rot_n
    idx_mode = _get_bits(lo, hi, pos, isb_n).astype(np.intp); pos += isb_n

    neps = nsub * 2
    # endpoint channels, stored channel-major: all R, all G, all B [, all A]
    chans = []
    nchan = 3 + (1 if ab else 0)
    for _c in range(nchan):
        bits_c = cb if _c < 3 else ab
        vals = np.empty((n, neps), dtype=np.uint64)
        for e in range(neps):
            vals[:, e] = _get_bits(lo, hi, pos, bits_c)
            pos += bits_c
        chans.append(vals)

    # p-bits
    pvals = None
    if npb:
        pvals = np.empty((n, neps), dtype=np.uint64)
        stored = npb
        raw = np.empty((n, stored), dtype=np.uint64)
        for i in range(stored):
            raw[:, i] = _get_bits(lo, hi, pos, 1)
            pos += 1
        if shared_pb:  # one p-bit per subset, shared by both endpoints
            for e in range(neps):
                pvals[:, e] = raw[:, e // 2]
        else:
            pvals = raw

    # dequantized endpoints -> (n, neps, 4)
    eps = np.zeros((n, neps, 4), dtype=np.uint32)
    for c in range(4):
        if c < nchan:
            bits_c = cb if c < 3 else ab
            pb = pvals[:, :] if pvals is not None else None
            eps[:, :, c] = _unquantize(
                chans[c], bits_c, pb if pb is not None else None
            )
        else:
            eps[:, :, c] = 255  # no alpha channel -> opaque

    # subset of each texel
    if nsub == 1:
        subset = np.zeros((n, 16), dtype=np.intp)
        anchors = [np.zeros(n, dtype=np.intp)]
    elif nsub == 2:
        subset = _P2[partition]
        anchors = [np.zeros(n, dtype=np.intp), _ANCHOR2_1[partition].astype(np.intp)]
    else:
        subset = _P3[partition]
        anchors = [np.zeros(n, dtype=np.intp),
                   _ANCHOR3_1[partition].astype(np.intp),
                   _ANCHOR3_2[partition].astype(np.intp)]
    subset = subset.astype(np.intp)

    def read_indices(width, anchor_list, start_pos):
        """Per-texel indices with anchor texels storing width-1 bits."""
        is_anchor = np.zeros((n, 16), dtype=bool)
        for a in anchor_list:
            is_anchor[np.arange(n), a] = True
        widths = np.where(is_anchor, width - 1, width)
        offs = np.zeros((n, 16), dtype=np.int64)
        offs[:, 1:] = np.cumsum(widths[:, :-1], axis=1)
        out = np.zeros((n, 16), dtype=np.uint32)
        # bit positions vary per block; extract per texel with vector ops
        for t in range(16):
            s = start_pos + offs[:, t]
            w = widths[:, t]
            # gather bits: since s varies per block, do it via uint64 shifts
            sel_lo = s < 64
            res = np.zeros(n, dtype=np.uint64)
            s_lo = np.where(sel_lo, s, 0).astype(np.uint64)
            lo_part = (lo >> s_lo)
            cross = (s < 64) & (s + w > 64)
            hi_shift = np.where(cross, 64 - s, 0).astype(np.uint64)
            lo_part = lo_part | np.where(cross, hi << hi_shift, 0)
            s_hi = np.where(~sel_lo, s - 64, 0).astype(np.uint64)
            hi_part = hi >> s_hi
            res = np.where(sel_lo, lo_part, hi_part)
            mask = (np.uint64(1) << w.astype(np.uint64)) - np.uint64(1)
            out[:, t] = (res & mask).astype(np.uint32)
        total = int(start_pos) if np.isscalar(start_pos) else start_pos
        return out, offs[:, -1] + widths[:, -1] + total

    idx1, _end = read_indices(ib, anchors, pos)
    n_index1_bits = 16 * ib - len(anchors)
    pos2 = pos + n_index1_bits
    if ib2:
        idx2, _ = read_indices(ib2, [np.zeros(n, dtype=np.intp)], pos2)
    else:
        idx2 = None

    # select endpoints per texel
    e0 = np.take_along_axis(
        eps, (subset * 2)[..., None].repeat(4, -1), axis=1
    ).astype(np.uint32)
    e1 = np.take_along_axis(
        eps, (subset * 2 + 1)[..., None].repeat(4, -1), axis=1
    ).astype(np.uint32)

    if mode == 4:
        # idx_mode selects which index set drives color vs alpha
        w_color = np.where(
            (idx_mode == 0)[:, None], _WEIGHTS[2][idx1], _WEIGHTS[3][idx2]
        ).astype(np.uint32)
        w_alpha = np.where(
            (idx_mode == 0)[:, None], _WEIGHTS[3][idx2], _WEIGHTS[2][idx1]
        ).astype(np.uint32)
    elif mode == 5:
        w_color = _WEIGHTS[2][idx1].astype(np.uint32)
        w_alpha = _WEIGHTS[2][idx2].astype(np.uint32)
    else:
        w_color = _WEIGHTS[ib][idx1].astype(np.uint32)
        w_alpha = w_color

    out = np.empty((n, 16, 4), dtype=np.uint8)
    for c in range(4):
        w = w_color if c < 3 else w_alpha
        out[:, :, c] = (
            (e0[:, :, c] * (64 - w) + e1[:, :, c] * w + 32) >> 6
    ).astype(np.uint8)

    # rotation: swap alpha with one color channel (modes 4, 5)
    if rot_n:
        for r, c in ((1, 0), (2, 1), (3, 2)):
            m = rotation == r
            if m.any():
                tmp = out[m][:, :, c].copy()
                out[m, :, c] = out[m][:, :, 3]
                out[m, :, 3] = tmp
    return out


def decode_bc7_numpy(data, width: int, height: int) -> np.ndarray:
    """Decode BC7 blocks to (height, width, 4) uint8 (all 8 modes)."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    n = bw * bh
    words = np.frombuffer(data, dtype="<u8", count=n * 2).reshape(n, 2)
    lo, hi = words[:, 0].copy(), words[:, 1].copy()

    byte0 = (lo & np.uint64(0xFF)).astype(np.uint32)
    texels = np.zeros((n, 16, 4), dtype=np.uint8)
    for mode in range(8):
        m = (byte0 & ((1 << (mode + 1)) - 1)) == (1 << mode)
        if not m.any():
            continue
        texels[m] = _decode_mode_group(lo[m], hi[m], mode)

    img = texels.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    return img.reshape(bh * 4, bw * 4, 4)[:height, :width].copy()



def encode_bc7_mode6_numpy(img: np.ndarray) -> np.ndarray:
    """Encode (h, w, 4) u8 RGBA → (bh·bw, 16) u8 BC7 blocks, mode 6.

    The synthetic-content pipeline for a compressed-resident BC7 pool
    (the bc7 twin of ``encode_bc1_numpy``; real assets pass their own
    blocks through verbatim). Mode 6 is the single-subset RGBA mode
    (7-bit endpoints + per-endpoint pbit, 4-bit indices): endpoints =
    per-channel min/max reconstructed through the pbit quantizer,
    indices by projection onto the endpoint diagonal, the anchor
    texel's implicit-MSB constraint handled by endpoint swap
    (weights[15-i] = 64-weights[i]). Deterministic; quality is
    fixture-grade, not a production encoder — decode defines truth.
    """
    img = np.ascontiguousarray(img[..., :4], np.uint8)
    h, w = img.shape[:2]
    bh, bw = (h + 3) // 4, (w + 3) // 4
    pad = np.pad(img, ((0, bh * 4 - h), (0, bw * 4 - w), (0, 0)),
                 mode="edge")
    blocks = pad.reshape(bh, 4, bw, 4, 4).transpose(0, 2, 1, 3, 4)
    blocks = blocks.reshape(-1, 16, 4).astype(np.int32)     # (B, 16, 4)
    nb = len(blocks)

    def quant(e):
        """8-bit endpoint vector → (v7 (B, 4), pbit (B,)) minimizing L1
        under the shared-pbit constraint; returns the reconstruction."""
        best = None
        for p in (0, 1):
            v7 = np.clip((e - p + 1) >> 1, 0, 127)
            r = (v7 << 1) | p
            err = np.abs(r - e).sum(1)
            if best is None:
                best = (err, v7, np.full(nb, p), r)
            else:
                take = err < best[0]
                best = (np.where(take, err, best[0]),
                        np.where(take[:, None], v7, best[1]),
                        np.where(take, p, best[2]),
                        np.where(take[:, None], r, best[3]))
        return best[1], best[2], best[3]

    v70, p0, r0 = quant(blocks.min(1))
    v71, p1, r1 = quant(blocks.max(1))
    d = (r1 - r0).astype(np.float32)
    dd = np.maximum((d * d).sum(1), 1e-9)
    t = (((blocks - r0[:, None]).astype(np.float32)
          * d[:, None]).sum(2) / dd[:, None])               # (B, 16)
    wtab = _WEIGHTS[4].astype(np.float32) / 64.0
    idx = np.abs(t[:, :, None] - wtab[None, None]).argmin(2)

    swap = idx[:, 0] >= 8
    v70s = np.where(swap[:, None], v71, v70)
    v71s = np.where(swap[:, None], v70, v71)
    p0s = np.where(swap, p1, p0)
    p1s = np.where(swap, p0, p1)
    idx = np.where(swap[:, None], 15 - idx, idx)

    bits = np.zeros((nb, 128), np.uint8)

    def put(pos, vals, count):
        for k in range(count):
            bits[:, pos + k] = (vals >> k) & 1

    bits[:, 6] = 1                                          # mode 6
    pos = 7
    for c in range(4):
        for v in (v70s[:, c], v71s[:, c]):
            put(pos, v, 7)
            pos += 7
    put(pos, p0s, 1)
    put(pos + 1, p1s, 1)
    pos += 2
    put(pos, idx[:, 0], 3)                                  # anchor: 3 bits
    pos += 3
    for tx in range(1, 16):
        put(pos, idx[:, tx], 4)
        pos += 4
    assert pos == 128
    weights = (1 << (np.arange(8, dtype=np.uint16) % 8)).astype(np.uint8)
    return (bits.reshape(nb, 16, 8) * weights).sum(2).astype(np.uint8)


def bc7_block_hints(blocks: np.ndarray) -> np.ndarray:
    """Bake per-block partition hints for the sample-time decode:
    (B, 16) u8 BC7 blocks → (B, 2) uint32 ``[subset_word, anchors]``.
    ``subset_word`` packs the block's 16 per-texel subset ids (2 bits
    each, texel order); ``anchors`` packs anchor texels 1 and 2 (bytes
    0-1; 0 where absent). Single-subset blocks (modes 4-6) bake zeros.
    Passing these to ``bc7_texel_device(hint=...)`` replaces the
    per-pixel 64-entry spec-table gathers of the partitioned modes with
    plain integer ops — hints are pure functions of the block bits, so
    they bake at upload, not per frame."""
    blocks = np.ascontiguousarray(blocks, np.uint8).reshape(-1, 16)
    byte0 = blocks[:, 0].astype(np.uint32)
    lo = np.zeros(len(blocks), np.uint64)
    for i in range(8):
        lo |= blocks[:, i].astype(np.uint64) << (8 * i)
    out = np.zeros((len(blocks), 2), np.uint32)
    for mode in (0, 1, 2, 3, 7):
        nsub, pbits_n = _MODES[mode][0], _MODES[mode][1]
        is_mode = (byte0 & ((1 << (mode + 1)) - 1)) == (1 << mode)
        if not is_mode.any():
            continue
        part = ((lo >> np.uint64(mode + 1))
                & np.uint64((1 << pbits_n) - 1)).astype(np.int32)
        if nsub == 2:
            subs = _P2[part]
            a1 = _ANCHOR2_1[part].astype(np.uint32)
            a2 = np.zeros_like(a1)
        else:
            subs = _P3[part]
            a1 = _ANCHOR3_1[part].astype(np.uint32)
            a2 = _ANCHOR3_2[part].astype(np.uint32)
        word = np.zeros(len(blocks), np.uint32)
        for tx in range(16):
            word |= subs[:, tx].astype(np.uint32) << (2 * tx)
        out[is_mode, 0] = word[is_mode]
        out[is_mode, 1] = (a1 | (a2 << 8))[is_mode]
    return out


# ---------------------------------------------------------------------------
# BC7 decode as integer torch ops: one texel per pixel (the sample-time
# decode of the bc7 pool) and a whole level (the load-time decode)
# ---------------------------------------------------------------------------


def _bc7_weight(idx, ib: int):
    """BC7 interpolation weight from the index value, arithmetically:
    ``(i * 64 + (N - 1) // 2) // (N - 1)`` with ``N = 2**ib`` reproduces
    the spec's weight tables (``_WEIGHTS``) for ib = 2, 3, 4, so a pixel
    pays integer ops instead of a table gather."""
    n1 = (1 << ib) - 1
    return torch.div(idx * 64 + (n1 >> 1), n1, rounding_mode="floor")


def _table(arr: np.ndarray, device) -> torch.Tensor:
    """A partition or anchor table, flat, as int64 on ``device``."""
    return torch.as_tensor(arr.reshape(-1).astype(np.int64), device=device)


_PARTITIONED = (0, 1, 2, 3, 7)


def bc7_texel_device(w, t, modes=tuple(range(8)), hint=None) -> list:
    """Decode one BC7 texel per pixel from its block's four 32-bit words.

    ``w``: a list of four tensors, the block's little-endian words, each
    held in int64 (0 .. 2**32 - 1: torch has no uint32 arithmetic on
    every device, and int64 keeps right shifts logical with bit 31 set;
    every left shift is masked back, and no shift amount reaches 64).
    The words stay separate tensors, never stacked. ``t``: the texel's
    index in its block, ``(yt & 3) * 4 + (xt & 3)``, broadcastable
    against the words. ``modes``: the BC7 modes computed, a static tuple
    (each listed mode is evaluated for every pixel and the block's mode
    byte selects, so the cost is the sum of the listed modes'; a block
    of an unlisted mode decodes to zeros). ``hint``: an optional pair
    ``(subset_word, anchors)`` of int64 tensors from ``bc7_block_hints``;
    with it the partitioned modes (0-3 and 7) take their texel's subset
    and anchors from the hint instead of the spec tables (exact: the
    hint is the block's own partition data).

    Equal to ``decode_bc7_numpy`` for blocks of the listed modes.
    Returns [r, g, b, a] int32 tensors."""
    words = [wi.to(torch.int64) for wi in w]
    dev = words[0].device
    t = torch.as_tensor(t, device=dev).to(torch.int64)

    def bits_static(pos: int, count: int):
        if count == 0:
            return torch.zeros_like(words[0])
        wi, bo = divmod(pos, 32)
        v = words[wi] >> bo
        if bo + count > 32:
            v = v | (words[wi + 1] << (32 - bo))
        return v & ((1 << count) - 1)

    def word_at(wi):
        return torch.where(wi <= 1, torch.where(wi == 0, words[0], words[1]),
                           torch.where(wi == 2, words[2], words[3]))

    def bits_dynamic(start, count):
        """``count`` (<= 8) bits at bit ``start`` (tensors)."""
        wi = start >> 5
        bo = start & 31
        lo = word_at(wi) >> bo
        # the next word's low bits, shifted by 32 - bo < 32 (never by 32)
        hi = word_at((wi + 1).clamp(max=3)) << torch.where(bo > 0, 32 - bo, 0)
        val = lo | torch.where((bo > 0) & (bo + count > 32), hi, 0)
        return val & ((torch.ones_like(count) << count) - 1)

    def unquant(ep, bits: int, pbit):
        if pbit is not None:
            ep = (ep << 1) | pbit
            bits = bits + 1
        ep = ep << (8 - bits)
        return ep | (ep >> bits)

    def decode_mode(mode: int) -> list:
        (nsub, pbits_n, rot_n, isb_n, cb, ab, npb, shared_pb, ib, ib2) = \
            _MODES[mode]
        pos = mode + 1
        partition = bits_static(pos, pbits_n)
        pos += pbits_n
        rotation = bits_static(pos, rot_n)
        pos += rot_n
        idx_mode = bits_static(pos, isb_n)
        pos += isb_n

        neps = nsub * 2
        nchan = 3 + (1 if ab else 0)
        raw = [[None] * neps for _ in range(nchan)]
        for c in range(nchan):
            bits_c = cb if c < 3 else ab
            for e in range(neps):
                raw[c][e] = bits_static(pos, bits_c)
                pos += bits_c
        pvals = None
        if npb:
            pv = []
            for _i in range(npb):
                pv.append(bits_static(pos, 1))
                pos += 1
            pvals = [pv[e // 2] for e in range(neps)] if shared_pb else pv

        # this texel's subset and the block's anchor texels
        if nsub == 1:
            subset = torch.zeros_like(t)
            anchors = []                      # besides texel 0
        elif hint is not None:
            subset = (hint[0] >> (2 * t)) & 3
            anchors = [hint[1] & 0xFF]
            if nsub == 3:
                anchors.append((hint[1] >> 8) & 0xFF)
        elif nsub == 2:
            subset = _table(_P2, dev)[partition * 16 + t]
            anchors = [_table(_ANCHOR2_1, dev)[partition]]
        else:
            subset = _table(_P3, dev)[partition * 16 + t]
            anchors = [_table(_ANCHOR3_1, dev)[partition],
                       _table(_ANCHOR3_2, dev)[partition]]

        # index-bit offset of texel t: every texel before it holds ib
        # bits, one less for each anchor before it (texel 0 included)
        off = ib * t - (t > 0).to(torch.int64)
        is_anchor = t == 0
        for a in anchors:
            off = off - (a < t).to(torch.int64)
            is_anchor = is_anchor | (t == a)
        idx1 = bits_dynamic(pos + off, ib - is_anchor.to(torch.int64))
        idx2 = None
        if ib2:
            pos2 = pos + 16 * ib - (1 + len(anchors))
            off2 = ib2 * t - (t > 0).to(torch.int64)
            idx2 = bits_dynamic(pos2 + off2, ib2 - (t == 0).to(torch.int64))

        def pick(vals):
            """vals[s] for this texel's subset s."""
            if nsub == 1:
                return vals[0]
            if nsub == 2:
                return torch.where(subset == 0, vals[0], vals[1])
            return torch.where(subset == 0, vals[0],
                               torch.where(subset == 1, vals[1], vals[2]))

        eps = []                              # [e0 / e1][channel]
        for k in range(2):
            chans = []
            for c in range(4):
                if c < nchan:
                    bits_c = cb if c < 3 else ab
                    chans.append(pick([unquant(
                        raw[c][2 * s + k], bits_c,
                        pvals[2 * s + k] if pvals else None)
                        for s in range(nsub)]))
                else:
                    chans.append(255)
            eps.append(chans)

        if mode == 4:
            wa = _bc7_weight(idx1, 2)
            wb = _bc7_weight(idx2, 3)
            w_color = torch.where(idx_mode == 0, wa, wb)
            w_alpha = torch.where(idx_mode == 0, wb, wa)
        elif mode == 5:
            w_color = _bc7_weight(idx1, 2)
            w_alpha = _bc7_weight(idx2, 2)
        else:
            w_color = _bc7_weight(idx1, ib)
            w_alpha = w_color

        out = []
        for c in range(4):
            wgt = w_color if c < 3 else w_alpha
            out.append((eps[0][c] * (64 - wgt) + eps[1][c] * wgt + 32) >> 6)
        if rot_n:
            for r, c in ((1, 0), (2, 1), (3, 2)):
                m = rotation == r
                col, alp = out[c], out[3]
                out[c] = torch.where(m, alp, col)
                out[3] = torch.where(m, col, alp)
        return out

    byte0 = words[0] & 0xFF
    shape = torch.broadcast_shapes(words[0].shape, t.shape)
    out = [torch.zeros(shape, dtype=torch.int64, device=t.device)
           for _ in range(4)]
    for mode in modes:
        is_mode = (byte0 & ((1 << (mode + 1)) - 1)) == (1 << mode)
        out = [torch.where(is_mode, d, o)
               for d, o in zip(decode_mode(mode), out)]
    return [o.to(torch.int32) for o in out]


def le_words(u, o: int, n: int) -> list:
    """``n`` little-endian 32-bit words from byte ``o`` on of (..., k)
    bytes ``u`` (any integer dtype) → int64 tensors (...,)."""
    u = u.to(torch.int64)
    return [u[..., o + 4 * k] | (u[..., o + 4 * k + 1] << 8)
            | (u[..., o + 4 * k + 2] << 16) | (u[..., o + 4 * k + 3] << 24)
            for k in range(n)]


def bc7_words(blocks) -> list:
    """(..., 16) u8 BC7 blocks → their four little-endian 32-bit words,
    each an int64 tensor (...,), for ``bc7_texel_device``."""
    return le_words(blocks, 0, 4)


def decode_bc7_device(data, width: int, height: int, *,
                      device=None) -> torch.Tensor:
    """Decode BC7 blocks (all 8 modes) to a (height, width, 4) uint8
    tensor: the load-time decode of a whole level.

    ``data``: the raw block bytes, a uint8 tensor (decoded on its own
    device unless ``device`` names another) or a bytes-like object or
    NumPy array (then ``device`` is required). Every mode decodes for
    every texel of every block and the block's mode byte selects, as in
    the reference; the per-texel arithmetic is ``bc7_texel_device``'s,
    with the 16 texels of a block as a second axis. Equal to
    ``decode_bc7_numpy``."""
    if isinstance(data, torch.Tensor):
        raw = data.to(device if device is not None else data.device)
    else:
        if device is None:
            raise ValueError("decode_bc7_device needs a device for "
                             "host data")
        host = (np.frombuffer(bytes(data), np.uint8)
                if isinstance(data, (bytes, bytearray, memoryview))
                else np.asarray(data, np.uint8))
        raw = torch.tensor(host, device=device)
    bw, bh = (width + 3) // 4, (height + 3) // 4
    n = bw * bh
    words = bc7_words(raw.reshape(-1)[: n * 16].reshape(n, 1, 16))
    t = torch.arange(16, dtype=torch.int64, device=raw.device)[None]
    texels = torch.stack(bc7_texel_device(words, t), -1)     # (n, 16, 4)
    img = texels.reshape(bh, bw, 4, 4, 4).permute(0, 2, 1, 3, 4)
    img = img.reshape(bh * 4, bw * 4, 4)[:height, :width]
    return img.to(torch.uint8).contiguous()
