"""Port vs reference: the GUI pass — the 5x7 font, the host canvas, the
device composite of a packed or unpacked frame, the HUD band and GMD
messages.

Tolerances:
- glyphs, ``text_width``, canvas pixels and ``GuiCanvas.packed()``:
  equal;
- the composite (torch ops): equal, bit for bit, to a NumPy f32
  evaluation in the JAX package's op order (``src * (1/255)``, then
  ``src * a + dst * (1 - a) + 0.5``, each op rounded); against JAX
  within 1 code per channel, on fewer than 0.1% of the channels (XLA's
  CPU backend may contract the blend into FMAs, which moves a value that
  sits on a rounding boundary);
- the HUD band, drawn by both packages' ``Hud.apply`` with one stub
  manager (fixed frame time, index and size): the canvas equal, the
  composite under the two rules above.
"""

import types

import numpy as np
import pytest
import torch

from mt_renderer_tpu.app import hud as jhud
from mt_renderer_tpu.formats import gmd as jgmd
from mt_renderer_tpu.scene import gui as jgui
from mt_renderer_tpu_torch import fixtures as tfix
from mt_renderer_tpu_torch.app import hud as thud
from mt_renderer_tpu_torch.formats import gmd as tgmd
from mt_renderer_tpu_torch.scene import gui as tgui

W, H = 80, 64
ALPHAS = (0, 1, 127, 128, 254, 255)


def pack(rgba: np.ndarray) -> np.ndarray:
    v = rgba.astype(np.uint32)
    return v[..., 0] | (v[..., 1] << 8) | (v[..., 2] << 16) | (v[..., 3] << 24)


def unpack(packed: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(packed)
    return a.view(np.uint8).reshape(a.shape[0], a.shape[1], 4)


def over_f32(frame_rgba: np.ndarray, ov_rgba: np.ndarray) -> np.ndarray:
    """NumPy f32 composite in the JAX package's op order; dst alpha kept."""
    a = ov_rgba[..., 3].astype(np.float32) * np.float32(1.0 / 255.0)
    out = frame_rgba.copy()
    for c in range(3):
        v = (ov_rgba[..., c].astype(np.float32) * a
             + frame_rgba[..., c].astype(np.float32) * (np.float32(1.0) - a)
             + np.float32(0.5))
        out[..., c] = np.clip(v, np.float32(0.0),
                              np.float32(255.0)).astype(np.uint8)
    return out


def frame_and_band(seed: int, rows: int):
    """A seeded frame and a band of ``rows`` rows, each side's alpha
    running through 0, 1, 127, 128, 254 and 255 (and random values)."""
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    band = rng.integers(0, 256, (rows, W, 4), dtype=np.uint8)
    for i, a in enumerate(ALPHAS):
        frame[i::7, :, 3] = a
        band[:, i::7, 3] = a
    return frame, band


def within_one_code(got: np.ndarray, want: np.ndarray) -> int:
    """Channels that differ (asserted within 1 code, on < 0.1%)."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1
    n = int((d > 0).sum())
    assert n < 0.001 * d.size, n
    return n


# ----------------------------------------------------------------- font


def test_glyph_table_matches_jax():
    np.testing.assert_array_equal(tgui._glyphs(), jgui._glyphs())
    assert (tgui.GLYPH_W, tgui.GLYPH_H, tgui.ADVANCE, tgui.WIDE_W) == \
        (jgui.GLYPH_W, jgui.GLYPH_H, jgui.ADVANCE, jgui.WIDE_W)
    for ch in ("A", " ", "|", "~", "あ", "\n"):
        np.testing.assert_array_equal(tgui.glyph(ch), jgui.glyph(ch))
    for code in (0x3042, 0x1F600, 0xE9, 0x10FFFF):
        np.testing.assert_array_equal(tgui.wide_glyph(code),
                                      jgui.wide_glyph(code))


@pytest.mark.parametrize("nonascii", ["box", "hex", "question"])
@pytest.mark.parametrize("scale", [1, 3])
def test_text_width_matches_jax(nonascii, scale):
    for s in ("", "x", "HELLO world 123", "こんにちは TPU", "a\tb"):
        assert tgui.text_width(s, scale, nonascii) == \
            jgui.text_width(s, scale, nonascii)


def _draw(gui_mod):
    c = gui_mod.GuiCanvas(W, 40)
    c.fill_rect(-5, -3, 30, 12, (10, 20, 30, 150))
    c.fill_rect(70, 30, 40, 40, (200, 100, 50, 255))
    x = c.draw_text(2, 1, "fps 59.9  frame 7", (255, 255, 255, 255))
    x2 = c.draw_text(-4, 12, "Clip me!", (255, 255, 80, 255), scale=2)
    x3 = c.draw_text(40, 30, "あ [x]", (1, 2, 3, 128), nonascii="hex")
    x4 = c.draw_text(5, 30, "漢字", (9, 8, 7, 6))
    return c, (x, x2, x3, x4)


def test_canvas_and_packing_match_jax():
    tc, tx = _draw(tgui)
    jc, jx = _draw(jgui)
    assert tx == jx
    np.testing.assert_array_equal(tc.rgba, jc.rgba)
    assert tc.packed().dtype == np.uint32
    np.testing.assert_array_equal(tc.packed(), jc.packed())
    tc.clear()
    assert not tc.rgba.any()


# ------------------------------------------------------------ composite


@pytest.mark.parametrize("rows,y0", [(H, 0), (9, 0), (9, 20), (9, H - 9),
                                     (1, 31)])
def test_packed_composite_matches_numpy_and_jax(rows, y0):
    frame, band = frame_and_band(rows * 100 + y0, rows)
    fp, bp = pack(frame), pack(band)
    got = tgui._composite_packed(torch.from_numpy(fp.view(np.int32)),
                                 torch.from_numpy(bp.view(np.int32)),
                                 y0=y0)
    assert got.dtype == torch.int32 and tuple(got.shape) == (H, W)
    got = unpack(got.numpy())
    want = frame.copy()
    want[y0:y0 + rows] = over_f32(frame[y0:y0 + rows], band)
    np.testing.assert_array_equal(got, want)
    # rows outside the band, and the frame's alpha, are untouched
    np.testing.assert_array_equal(got[..., 3], frame[..., 3])
    jax_out = unpack(np.asarray(jgui._composite_packed(fp, bp, y0=y0)))
    within_one_code(got, jax_out)


@pytest.mark.parametrize("rows,y0", [(H, 0), (12, 0), (12, 17)])
def test_u8_composite_matches_numpy_and_jax(rows, y0):
    frame, band = frame_and_band(rows + 7 * y0, rows)
    bp = pack(band)
    got = tgui._composite_u8(torch.from_numpy(frame),
                             torch.from_numpy(bp.view(np.int32)), y0=y0)
    assert got.dtype == torch.uint8
    got = got.numpy()
    want = frame.copy()
    want[y0:y0 + rows] = over_f32(frame[y0:y0 + rows], band)
    np.testing.assert_array_equal(got, want)
    within_one_code(got, np.asarray(jgui._composite_u8(frame, bp, y0=y0)))


def test_composite_keeps_every_alpha_pair():
    """Every (frame alpha, band alpha) pair of 0, 1, 127, 128, 254, 255,
    over every color pair of 0, 128 and 255: the packed and the unpacked
    paths agree with each other and with the NumPy evaluation."""
    vals = np.array([0, 128, 255], np.uint8)
    rows = []
    for fa in ALPHAS:
        for ba in ALPHAS:
            for fc in vals:
                for bc in vals:
                    rows.append(((fc, 255 - fc, fc, fa), (bc, bc, 255 - bc,
                                                          ba)))
    n = len(rows)
    frame = np.array([r[0] for r in rows], np.uint8).reshape(1, n, 4)
    band = np.array([r[1] for r in rows], np.uint8).reshape(1, n, 4)
    want = over_f32(frame, band)
    p = tgui._composite_packed(torch.from_numpy(pack(frame).view(np.int32)),
                               torch.from_numpy(pack(band).view(np.int32)))
    u = tgui._composite_u8(torch.from_numpy(frame),
                           torch.from_numpy(pack(band).view(np.int32)))
    np.testing.assert_array_equal(unpack(p.numpy()), want)
    np.testing.assert_array_equal(u.numpy(), want)


def test_composite_refuses_a_band_that_does_not_fit():
    fp = torch.zeros((H, W), dtype=torch.int32)
    with pytest.raises(ValueError):
        tgui._composite_packed(fp, torch.zeros((9, W), dtype=torch.int32),
                               y0=H - 8)
    with pytest.raises(ValueError):
        tgui._composite_packed(fp, torch.zeros((9, W + 1),
                                               dtype=torch.int32))


def test_overlay_uploads_once_per_touch_and_takes_numpy():
    frame, band = frame_and_band(5, 10)
    o = tgui.GuiOverlay(W, 10, y0=3)
    o.canvas.rgba[:] = band
    o.touch()
    fp = torch.from_numpy(pack(frame).view(np.int32))
    a = o.apply(fp)
    dev0 = o._dev
    b = o.apply(pack(frame))                 # a uint32 NumPy frame
    assert o._dev is dev0
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = o.apply(frame)                       # the u8 path
    np.testing.assert_array_equal(unpack(a.numpy()), c.numpy())
    o.canvas.fill_rect(0, 0, 4, 4, (9, 9, 9, 9))
    o.touch()
    o.apply(fp)
    assert o._dev is not dev0
    # a transparent canvas is the identity
    empty = tgui.GuiOverlay(W, H)
    torch.testing.assert_close(empty.apply(fp), fp, rtol=0, atol=0)


# ------------------------------------------------------------- HUD, GMD


def _stub_mgr():
    return types.SimpleNamespace(frame_time=0.0125, frame_index=42,
                                 width=W, height=H)


@pytest.fixture(scope="module")
def gmd_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("hud") / "fixture_messages.gmd"
    p.write_bytes(tfix.build_gmd())
    return str(p)


@pytest.mark.parametrize("label", [None, "first", "LABEL_BYE"])
def test_hud_band_matches_jax(gmd_path, label):
    kw = {} if label is None else dict(gmd_path=gmd_path)
    if label == "LABEL_BYE":
        kw["gmd_label"] = label
    th, jh = thud.Hud(W, **kw), jhud.Hud(W, **kw)
    assert th.msg_lines == jh.msg_lines
    assert th.overlay.canvas.height == jh.overlay.canvas.height
    frame, _ = frame_and_band(9, 1)
    fp = pack(frame)
    got = th.apply(_stub_mgr(), torch.from_numpy(fp.view(np.int32)),
                   extra="world")
    want = jh.apply(_stub_mgr(), fp, extra="world")
    np.testing.assert_array_equal(th.overlay.canvas.rgba,
                                  jh.overlay.canvas.rgba)
    assert th.overlay.canvas.rgba.any()
    got = unpack(got.numpy())
    bh = th.overlay.canvas.height
    ref = frame.copy()
    ref[:bh] = over_f32(frame[:bh], th.overlay.canvas.rgba)
    np.testing.assert_array_equal(got, ref)
    within_one_code(got, unpack(np.asarray(want)))
    # the unpacked path draws the same band
    got_u8 = th.apply(_stub_mgr(), torch.from_numpy(frame), extra="world")
    np.testing.assert_array_equal(got_u8.numpy(), ref)


def test_hud_missing_label_exits(gmd_path):
    with pytest.raises(SystemExit):
        thud.Hud(64, gmd_path=gmd_path, gmd_label="missing")


def _messages(gmd_mod):
    g = gmd_mod.GuiMessageFile(language_id=1, package_name="hud")
    g.messages = [
        gmd_mod.GuiMessage(label="greeting", message="HELLO GPU"),
        gmd_mod.GuiMessage(label="multi", message="line one\r\nline two"),
        gmd_mod.GuiMessage(label="jp", message="こんにちは <E100>"),
    ]
    return gmd_mod.GuiMessageFile.parse(g.tobytes())


@pytest.mark.parametrize("which", ["greeting", 1, "jp"])
@pytest.mark.parametrize("nonascii", ["box", "hex"])
def test_draw_gmd_message_matches_jax(which, nonascii):
    out = []
    for gui_mod, gmd_mod in ((tgui, tgmd), (jgui, jgmd)):
        c = gui_mod.GuiCanvas(160, 24)
        y = gui_mod.draw_gmd_message(c, _messages(gmd_mod), which, 3, 1,
                                     scale=1, nonascii=nonascii)
        out.append((y, c.rgba))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert out[0][1].any()
    with pytest.raises(StopIteration):
        tgui.draw_gmd_message(tgui.GuiCanvas(8, 8), _messages(tgmd),
                              "nope", 0, 0)
