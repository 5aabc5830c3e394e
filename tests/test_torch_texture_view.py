"""Port vs reference: the texture view (aspect-fit bilinear quad, flipped
v, white letterbox, optional YCbCr decode with the 123/255 chroma bias).

Seeded square, wide and tall RGBA8 textures go through the JAX
package's ``view_texture`` and the port's, raw and YCbCr, magnified and
minified. Tolerances: the port (torch ops, each rounded on its own)
equals, bit for bit, a NumPy f32 evaluation in the JAX package's op
order. Against JAX it is within 1 code per channel, and every channel
that differs is a rounding tie: its value, evaluated in f64, lies within
1e-3 of a code boundary. XLA's algebraic simplifier rewrites the
program (a division by a constant becomes a product with its
reciprocal, chains of constant factors fold into one: ``(i + 0.5) / W *
2`` runs as ``(i + 0.5) * (2 / W)``), which moves a texel coordinate by
an ulp; where bilinear weights of 1/4 or 1/2 land a value exactly on
k + 0.5 the two round apart. Such ties are common in magnified and
minified views, so the count of differing channels is not bounded by a
share: in these cases it reaches 1.04% of the channels (the 64x64
texture minified into 40x24, raw) and 0.85% (the 5x7 texture magnified
into 96x64, raw).
"""

import numpy as np
import pytest
import torch

from mt_renderer_tpu.render import texture_view as jtv
from mt_renderer_tpu_torch.render import texture_view as ttv
from torch_threads import one_thread  # noqa: F401

F = np.float32


def view_f32(tex: np.ndarray, width: int, height: int,
             ycbcr: bool) -> np.ndarray:
    """NumPy f32, the JAX package's ops in its order, each rounded."""
    th, tw = tex.shape[:2]
    scale = min(width / tw, height / th)
    qw, qh = F(tw * scale / width), F(th * scale / height)
    xs = (np.arange(width, dtype=F) + F(0.5)) / F(width) * F(2) - F(1)
    ys = F(1) - (np.arange(height, dtype=F) + F(0.5)) / F(height) * F(2)
    u = (xs / qw + F(1)) * F(0.5)
    v = (ys / qh + F(1)) * F(0.5)
    onquad = (((u >= 0) & (u <= 1))[None, :] & ((v >= 0) & (v <= 1))[:, None])
    vv = F(1) - v
    t = tex.astype(F) / F(255)
    x = np.clip(u * F(tw) - F(0.5), F(0), F(tw - 1))
    y = np.clip(vv * F(th) - F(0.5), F(0), F(th - 1))
    x0 = np.floor(x).astype(np.int32)
    y0 = np.floor(y).astype(np.int32)
    fx = (x - x0.astype(F))[None, :, None]
    fy = (y - y0.astype(F))[:, None, None]
    x1 = np.minimum(x0 + 1, tw - 1)
    y1 = np.minimum(y0 + 1, th - 1)
    c00, c10 = t[y0][:, x0], t[y0][:, x1]
    c01, c11 = t[y1][:, x0], t[y1][:, x1]
    s = ((c00 * (F(1) - fx) + c10 * fx) * (F(1) - fy)
         + (c01 * (F(1) - fx) + c11 * fx) * fy)
    if ycbcr:
        cr = s[..., 0] - F(ttv.YCBCR_BIAS)
        cb = s[..., 2] - F(ttv.YCBCR_BIAS)
        yy = s[..., 3]
        s = np.stack([cr * F(1.40199995) + yy,
                      cr * F(-0.714139998) + cb * F(-0.344139993) + yy,
                      cb * F(1.77199996) + yy, s[..., 1]], -1)
    out = np.where(onquad[..., None], s, F(1))
    return np.clip(out * F(255) + F(0.5), F(0), F(255)).astype(np.uint8)


def view_f64(tex: np.ndarray, width: int, height: int,
             ycbcr: bool) -> np.ndarray:
    """The same view in f64, before the final truncation: ``out * 255 +
    0.5``, whose distance to the nearest integer says how close a channel
    sits to a rounding boundary."""
    d = np.float64
    th, tw = tex.shape[:2]
    scale = min(width / tw, height / th)
    qw, qh = tw * scale / width, th * scale / height
    u = ((np.arange(width, dtype=d) + 0.5) / width * 2 - 1) / qw * 0.5 + 0.5
    v = (1 - (np.arange(height, dtype=d) + 0.5) / height * 2) / qh * 0.5 \
        + 0.5
    onquad = (((u >= 0) & (u <= 1))[None, :] & ((v >= 0) & (v <= 1))[:, None])
    t = tex.astype(d) / 255
    x = np.clip(u * tw - 0.5, 0, tw - 1)
    y = np.clip((1 - v) * th - 0.5, 0, th - 1)
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = (x - x0)[None, :, None], (y - y0)[:, None, None]
    x1, y1 = np.minimum(x0 + 1, tw - 1), np.minimum(y0 + 1, th - 1)
    s = ((t[y0][:, x0] * (1 - fx) + t[y0][:, x1] * fx) * (1 - fy)
         + (t[y1][:, x0] * (1 - fx) + t[y1][:, x1] * fx) * fy)
    if ycbcr:
        cr, cb = s[..., 0] - ttv.YCBCR_BIAS, s[..., 2] - ttv.YCBCR_BIAS
        s = np.stack([cr * 1.40199995 + s[..., 3],
                      cr * -0.714139998 + cb * -0.344139993 + s[..., 3],
                      cb * 1.77199996 + s[..., 3], s[..., 1]], -1)
    return np.where(onquad[..., None], s, 1.0) * 255 + 0.5


def texture(th: int, tw: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (th, tw, 4), dtype=np.uint8)
    tex[: th // 3] = tex[: th // 3] // 64 * 64           # flat runs too
    return tex


CASES = [  # (texture rows, cols), (frame width, height)
    ((32, 32), (64, 64)),
    ((16, 40), (72, 64)),      # wide: letterboxed top and bottom
    ((48, 12), (64, 80)),      # tall: pillarboxed left and right
    ((5, 7), (96, 64)),        # magnified far past the texels
    ((64, 64), (40, 24)),      # minified
]


@pytest.mark.parametrize("ycbcr", [False, True], ids=["raw", "ycbcr"])
@pytest.mark.parametrize("tex_shape,frame", CASES,
                         ids=[f"{a}x{b}-{c}x{d}" for (a, b), (c, d) in CASES])
def test_view_texture_matches_numpy_and_jax(tex_shape, frame, ycbcr):
    tex = texture(*tex_shape, seed=sum(tex_shape) + 3 * ycbcr)
    w, h = frame
    got = ttv.view_texture(torch.from_numpy(tex), width=w, height=h,
                           ycbcr=ycbcr)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (h, w, 4)
    got = got.numpy()
    np.testing.assert_array_equal(got, view_f32(tex, w, h, ycbcr))
    want = np.asarray(jtv.view_texture(tex, width=w, height=h, ycbcr=ycbcr))
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1
    exact = view_f64(tex, w, h, ycbcr)
    tie = np.abs(exact - np.round(exact)) < 1e-3
    assert not (d > 0)[~tie].any()
    assert tie.mean() < 0.06            # ties are a few percent at most
    # the letterbox is white
    th, tw = tex_shape
    if tw / th > w / h:
        assert (got[0] == 255).all() and (got[-1] == 255).all()
    elif tw / th < w / h:
        assert (got[:, 0] == 255).all() and (got[:, -1] == 255).all()


def test_ycbcr_matches_numpy_and_jax():
    rng = np.random.default_rng(8)
    s = rng.random((257, 4), dtype=np.float32)
    s[0] = [ttv.YCBCR_BIAS, 1.0, ttv.YCBCR_BIAS, 0.5]     # gray 0.5
    got = ttv.ycbcr_to_rgba(torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got[0], [0.5, 0.5, 0.5, 1.0], atol=1e-6)
    cr, cb, y = s[:, 0] - F(ttv.YCBCR_BIAS), s[:, 2] - F(ttv.YCBCR_BIAS), \
        s[:, 3]
    want = np.stack([cr * F(1.40199995) + y,
                     cr * F(-0.714139998) + cb * F(-0.344139993) + y,
                     cb * F(1.77199996) + y, s[:, 1]], -1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.asarray(jtv.ycbcr_to_rgba(s)),
                               rtol=0, atol=2e-7)
    assert ttv.YCBCR_BIAS == jtv.YCBCR_BIAS
