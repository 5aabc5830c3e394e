"""Texture viewer device path — fullscreen aspect-fit quad + optional
YCbCr decode, as torch ops on the texture's device.

Mirrors the reference textureviewer's fragment behavior
(``src/shaders/textureviewer.wgsl:28-45`` and the scale uniform,
``bin/textureviewer.rs:21-31,179-189``): the game stores some GUI
textures with channels swizzled as (Cr, A, Cb, Y); the shader samples with
a flipped v, swizzles, and converts YCbCr→RGB with a 123/255 bias.

Every op rounds on its own in f32, in the JAX package's op order. Every
division takes a tensor divisor on the texture's device: torch's CUDA
divide by a host scalar multiplies by its reciprocal, which can differ
from the CPU's quotient in the last bit.
"""

from __future__ import annotations

import torch

YCBCR_BIAS = 0.482353002  # = 123/255, the game shader's chroma bias


def ycbcr_to_rgba(s: torch.Tensor) -> torch.Tensor:
    """(..., 4) swizzled sample → RGBA, all float 0-1.

    Input channel meaning: x=Cr, y=A, z=Cb, w=Y."""
    cr = s[..., 0] - YCBCR_BIAS
    a = s[..., 1]
    cb = s[..., 2] - YCBCR_BIAS
    y = s[..., 3]
    r = cr * 1.40199995 + y
    g = cr * -0.714139998 + cb * -0.344139993 + y
    b = cb * 1.77199996 + y
    return torch.stack([r, g, b, a], dim=-1)


def view_texture(tex: torch.Tensor, *, width: int = 512, height: int = 512,
                 ycbcr: bool = True) -> torch.Tensor:
    """Render (TH, TW, 4) uint8 aspect-fit into an (H, W, 4) uint8 frame
    on ``tex``'s device.

    Bilinear sample (the reference's mag filter), white letterbox."""
    dev = tex.device
    th, tw = tex.shape[:2]
    scale = min(width / tw, height / th)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    qw = f32(tw * scale / width)       # quad extent in [0, 1] of half-frame
    qh = f32(th * scale / height)

    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) \
        / f32(width) * 2.0 - 1.0
    ys = 1.0 - (torch.arange(height, dtype=torch.float32, device=dev)
                + 0.5) / f32(height) * 2.0
    u = (xs / qw + 1.0) * 0.5          # quad-local texcoord
    v = (ys / qh + 1.0) * 0.5
    onquad = (((u >= 0.0) & (u <= 1.0))[None, :]
              & ((v >= 0.0) & (v <= 1.0))[:, None])

    # the reference flips v at sample time (textureviewer.wgsl:31)
    vv = 1.0 - v
    t = tex.to(torch.float32) / f32(255.0)
    x = torch.clamp(u * tw - 0.5, 0.0, tw - 1.0)
    y = torch.clamp(vv * th - 0.5, 0.0, th - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0)[None, :, None]
    fy = (y - y0)[:, None, None]
    x1 = torch.clamp(x0 + 1, max=tw - 1)
    y1 = torch.clamp(y0 + 1, max=th - 1)
    c00 = t[y0[:, None], x0[None, :]]
    c10 = t[y0[:, None], x1[None, :]]
    c01 = t[y1[:, None], x0[None, :]]
    c11 = t[y1[:, None], x1[None, :]]
    s = (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (
        c01 * (1 - fx) + c11 * fx
    ) * fy

    rgba = ycbcr_to_rgba(s) if ycbcr else s
    out = torch.where(onquad[..., None], rgba, torch.ones_like(rgba))
    return torch.clamp(out * 255.0 + 0.5, 0, 255).to(torch.uint8)
