"""BC1 block-compressed texture decoding and encoding.

The BC1 half of ``mt_renderer_tpu/render/bcn.py``: the NumPy functions
are copies of the reference's, under its names; ``decode_bc1_device`` is
its device decode as integer torch ops on an explicit device. The BC7
half comes with the bc7 pool (ROADMAP Queue 1, item 13).

BC1 (DXT1): 8-byte blocks of two RGB565 endpoints and 32 2-bit indices,
the palette's interpolants ``(2a + b + 1) // 3`` (four-color blocks,
c0 > c1) or ``(a + b) // 2`` and transparent black (three-color,
punch-through blocks), per the public BC1 specification.
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
