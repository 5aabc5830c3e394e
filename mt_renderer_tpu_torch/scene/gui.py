"""2D GUI overlay — text/rect HUD composited over rendered frames.

The reference's rGUI parser is an unimplemented ``todo!()``
(``src/rgui.rs:8-10``), so there is no binary GUI format to parse; what
BASELINE config 5's "rGUI/debug_overlay composite" asks for is the *GUI
pass*: a 2D layer composited over the 3D frame. This module provides it:

* a host-side RGBA canvas (NumPy) with rect fill and 5x7 bitmap text —
  GMD messages plug straight in (``GuiMessageFile`` → message string →
  ``draw_text``), closing the loop between the parsed text assets and
  the renderer;
* a device-side composite: elementwise torch ops, on the frame's device,
  src-alpha over on the PACKED (H, W) int32 production frame (the RGBA8
  bits; ``device.pack_u32_channels``) — unpack/blend/repack as
  shift/mask arithmetic on (h, W) planes in int64, so bit 31 (every
  opaque pixel's alpha) never meets a signed shift, narrowed once to the
  int32 bits. Unpacked (H, W, 4) u8 frames (the texture view) composite
  through the same math on channel slices;
* static overlays upload once; animated HUDs (fps counters) re-upload
  only their small canvas band when it changes (``touch``) — the same
  host→device traffic class as the per-frame camera/bone uniforms (the
  analog of ``queue.write_buffer``, renderer_app_manager.rs:219-221).

Blend rule: src-alpha over on the color channels, matching the engine
blend state (``src/model.rs:242-247``); output alpha keeps the FRAME's
alpha (a GUI pass must not punch presentation holes into the frame it
decorates), quantized ``clip(x + 0.5)`` like every other blend in the
pipeline. Every op is its own f32 rounding, in the order
``src * a + dst * (1 - a) + 0.5``, so the CPU and the card give the same
bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Classic public 5x7 column font (ASCII 32..126): 5 bytes per glyph,
# each byte one COLUMN, bit 0 = top row — the de-facto-standard table
# every small character LCD ships (same "public constants" category as
# the BC7 weight tables in render/bcn.py).
_FONT5X7 = bytes([
    0x00, 0x00, 0x00, 0x00, 0x00,   # ' '
    0x00, 0x00, 0x5F, 0x00, 0x00,   # '!'
    0x00, 0x07, 0x00, 0x07, 0x00,   # '"'
    0x14, 0x7F, 0x14, 0x7F, 0x14,   # '#'
    0x24, 0x2A, 0x7F, 0x2A, 0x12,   # '$'
    0x23, 0x13, 0x08, 0x64, 0x62,   # '%'
    0x36, 0x49, 0x55, 0x22, 0x50,   # '&'
    0x00, 0x05, 0x03, 0x00, 0x00,   # '\''
    0x00, 0x1C, 0x22, 0x41, 0x00,   # '('
    0x00, 0x41, 0x22, 0x1C, 0x00,   # ')'
    0x14, 0x08, 0x3E, 0x08, 0x14,   # '*'
    0x08, 0x08, 0x3E, 0x08, 0x08,   # '+'
    0x00, 0x50, 0x30, 0x00, 0x00,   # ','
    0x08, 0x08, 0x08, 0x08, 0x08,   # '-'
    0x00, 0x60, 0x60, 0x00, 0x00,   # '.'
    0x20, 0x10, 0x08, 0x04, 0x02,   # '/'
    0x3E, 0x51, 0x49, 0x45, 0x3E,   # '0'
    0x00, 0x42, 0x7F, 0x40, 0x00,   # '1'
    0x42, 0x61, 0x51, 0x49, 0x46,   # '2'
    0x21, 0x41, 0x45, 0x4B, 0x31,   # '3'
    0x18, 0x14, 0x12, 0x7F, 0x10,   # '4'
    0x27, 0x45, 0x45, 0x45, 0x39,   # '5'
    0x3C, 0x4A, 0x49, 0x49, 0x30,   # '6'
    0x01, 0x71, 0x09, 0x05, 0x03,   # '7'
    0x36, 0x49, 0x49, 0x49, 0x36,   # '8'
    0x06, 0x49, 0x49, 0x29, 0x1E,   # '9'
    0x00, 0x36, 0x36, 0x00, 0x00,   # ':'
    0x00, 0x56, 0x36, 0x00, 0x00,   # ';'
    0x08, 0x14, 0x22, 0x41, 0x00,   # '<'
    0x14, 0x14, 0x14, 0x14, 0x14,   # '='
    0x00, 0x41, 0x22, 0x14, 0x08,   # '>'
    0x02, 0x01, 0x51, 0x09, 0x06,   # '?'
    0x32, 0x49, 0x79, 0x41, 0x3E,   # '@'
    0x7E, 0x11, 0x11, 0x11, 0x7E,   # 'A'
    0x7F, 0x49, 0x49, 0x49, 0x36,   # 'B'
    0x3E, 0x41, 0x41, 0x41, 0x22,   # 'C'
    0x7F, 0x41, 0x41, 0x22, 0x1C,   # 'D'
    0x7F, 0x49, 0x49, 0x49, 0x41,   # 'E'
    0x7F, 0x09, 0x09, 0x09, 0x01,   # 'F'
    0x3E, 0x41, 0x49, 0x49, 0x7A,   # 'G'
    0x7F, 0x08, 0x08, 0x08, 0x7F,   # 'H'
    0x00, 0x41, 0x7F, 0x41, 0x00,   # 'I'
    0x20, 0x40, 0x41, 0x3F, 0x01,   # 'J'
    0x7F, 0x08, 0x14, 0x22, 0x41,   # 'K'
    0x7F, 0x40, 0x40, 0x40, 0x40,   # 'L'
    0x7F, 0x02, 0x0C, 0x02, 0x7F,   # 'M'
    0x7F, 0x04, 0x08, 0x10, 0x7F,   # 'N'
    0x3E, 0x41, 0x41, 0x41, 0x3E,   # 'O'
    0x7F, 0x09, 0x09, 0x09, 0x06,   # 'P'
    0x3E, 0x41, 0x51, 0x21, 0x5E,   # 'Q'
    0x7F, 0x09, 0x19, 0x29, 0x46,   # 'R'
    0x46, 0x49, 0x49, 0x49, 0x31,   # 'S'
    0x01, 0x01, 0x7F, 0x01, 0x01,   # 'T'
    0x3F, 0x40, 0x40, 0x40, 0x3F,   # 'U'
    0x1F, 0x20, 0x40, 0x20, 0x1F,   # 'V'
    0x3F, 0x40, 0x38, 0x40, 0x3F,   # 'W'
    0x63, 0x14, 0x08, 0x14, 0x63,   # 'X'
    0x07, 0x08, 0x70, 0x08, 0x07,   # 'Y'
    0x61, 0x51, 0x49, 0x45, 0x43,   # 'Z'
    0x00, 0x7F, 0x41, 0x41, 0x00,   # '['
    0x02, 0x04, 0x08, 0x10, 0x20,   # '\\'
    0x00, 0x41, 0x41, 0x7F, 0x00,   # ']'
    0x04, 0x02, 0x01, 0x02, 0x04,   # '^'
    0x40, 0x40, 0x40, 0x40, 0x40,   # '_'
    0x00, 0x01, 0x02, 0x04, 0x00,   # '`'
    0x20, 0x54, 0x54, 0x54, 0x78,   # 'a'
    0x7F, 0x48, 0x44, 0x44, 0x38,   # 'b'
    0x38, 0x44, 0x44, 0x44, 0x20,   # 'c'
    0x38, 0x44, 0x44, 0x48, 0x7F,   # 'd'
    0x38, 0x54, 0x54, 0x54, 0x18,   # 'e'
    0x08, 0x7E, 0x09, 0x01, 0x02,   # 'f'
    0x0C, 0x52, 0x52, 0x52, 0x3E,   # 'g'
    0x7F, 0x08, 0x04, 0x04, 0x78,   # 'h'
    0x00, 0x44, 0x7D, 0x40, 0x00,   # 'i'
    0x20, 0x40, 0x44, 0x3D, 0x00,   # 'j'
    0x7F, 0x10, 0x28, 0x44, 0x00,   # 'k'
    0x00, 0x41, 0x7F, 0x40, 0x00,   # 'l'
    0x7C, 0x04, 0x18, 0x04, 0x78,   # 'm'
    0x7C, 0x08, 0x04, 0x04, 0x78,   # 'n'
    0x38, 0x44, 0x44, 0x44, 0x38,   # 'o'
    0x7C, 0x14, 0x14, 0x14, 0x08,   # 'p'
    0x08, 0x14, 0x14, 0x18, 0x7C,   # 'q'
    0x7C, 0x08, 0x04, 0x04, 0x08,   # 'r'
    0x48, 0x54, 0x54, 0x54, 0x20,   # 's'
    0x04, 0x3F, 0x44, 0x40, 0x20,   # 't'
    0x3C, 0x40, 0x40, 0x20, 0x7C,   # 'u'
    0x1C, 0x20, 0x40, 0x20, 0x1C,   # 'v'
    0x3C, 0x40, 0x30, 0x40, 0x3C,   # 'w'
    0x44, 0x28, 0x10, 0x28, 0x44,   # 'x'
    0x0C, 0x50, 0x50, 0x50, 0x3C,   # 'y'
    0x44, 0x64, 0x54, 0x4C, 0x44,   # 'z'
    0x00, 0x08, 0x36, 0x41, 0x00,   # '{'
    0x00, 0x00, 0x7F, 0x00, 0x00,   # '|'
    0x00, 0x41, 0x36, 0x08, 0x00,   # '}'
    0x08, 0x04, 0x08, 0x10, 0x08,   # '~'
])

GLYPH_W, GLYPH_H = 5, 7
ADVANCE = GLYPH_W + 1                 # one blank column between glyphs


@functools.lru_cache(maxsize=None)
def _glyphs() -> np.ndarray:
    """(95, GLYPH_H, GLYPH_W) bool — printable ASCII 32..126."""
    cols = np.frombuffer(_FONT5X7, np.uint8).reshape(-1, GLYPH_W)
    rows = (cols[:, None, :] >> np.arange(GLYPH_H, dtype=np.uint8)
            [None, :, None]) & 1
    return rows.astype(bool)


def glyph(ch: str) -> np.ndarray:
    """(GLYPH_H, GLYPH_W) bool bitmap from the ASCII table; unmapped
    chars substitute '?'. ``draw_text`` routes non-ASCII through
    ``wide_glyph`` instead — call this only for the 5x7 ASCII font."""
    code = ord(ch)
    if not 32 <= code <= 126:
        code = ord("?")
    return _glyphs()[code - 32]


WIDE_W = 2 * GLYPH_W + 1              # double-width cell, like CJK text
WIDE_ADVANCE = WIDE_W + 1


@functools.lru_cache(maxsize=1024)
def wide_glyph(code: int) -> np.ndarray:
    """(GLYPH_H, WIDE_W) bool — the non-ASCII fallback glyph: a
    double-width outline box whose interior pattern is the codepoint's
    bits (cell i of the 5x9 interior = bit ``i % 21`` of the
    codepoint, 21 bits covering all of Unicode). Deterministic, and
    distinct codepoints get distinct boxes — a GMD message full of
    SHIFT-JIS text renders as a stable, diffable pattern instead of a
    wall of '?' (the engine's real message tables are Japanese;
    src/util/read_struct.rs:60-86 treats SHIFT-JIS as
    first-class). For a human-readable fallback use
    ``draw_text(..., nonascii="hex")``."""
    g = np.zeros((GLYPH_H, WIDE_W), bool)
    g[0, :] = g[-1, :] = g[:, 0] = g[:, -1] = True
    ih, iw = GLYPH_H - 2, WIDE_W - 2
    bits = (code >> (np.arange(ih * iw) % 21)) & 1
    g[1:-1, 1:-1] = bits.reshape(ih, iw).astype(bool)
    return g


def _char_cells(s: str, nonascii: str = "box"):
    """Expand ``s`` into (bitmap, advance) draw cells under the
    non-ASCII policy: "box" (wide_glyph), "hex" ('[XXXX]' in ASCII),
    or "question" (the legacy '?' substitution)."""
    for ch in s:
        code = ord(ch)
        if 32 <= code <= 126:
            yield _glyphs()[code - 32], ADVANCE
        elif nonascii == "hex":
            for c2 in "[%04X]" % code:
                yield _glyphs()[ord(c2) - 32], ADVANCE
        elif nonascii == "question":
            yield _glyphs()[ord("?") - 32], ADVANCE
        else:
            yield wide_glyph(code), WIDE_ADVANCE


def text_width(s: str, scale: int = 1, nonascii: str = "box") -> int:
    w = sum(adv for _, adv in _char_cells(s, nonascii))
    return (w - 1) * scale if w else 0


class GuiCanvas:
    """Host-side RGBA canvas (straight alpha, uint8)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.rgba = np.zeros((height, width, 4), np.uint8)

    def clear(self) -> None:
        self.rgba.fill(0)

    def fill_rect(self, x: int, y: int, w: int, h: int, rgba) -> None:
        x0, y0 = max(x, 0), max(y, 0)
        x1 = min(x + w, self.width)
        y1 = min(y + h, self.height)
        if x1 > x0 and y1 > y0:
            self.rgba[y0:y1, x0:x1] = np.asarray(rgba, np.uint8)

    def draw_text(self, x: int, y: int, s: str,
                  rgba=(255, 255, 255, 255), scale: int = 1,
                  nonascii: str = "box") -> int:
        """Draw ``s`` with its top-left at (x, y); returns the x just
        past the last glyph. Non-ASCII (e.g. SHIFT-JIS/CJK text from
        GMD messages) renders under the ``nonascii`` policy:
        "box" (default) — a deterministic double-width codepoint box
        (``wide_glyph``); "hex" — '[XXXX]' in ASCII; "question" — the
        legacy '?' substitution."""
        col = np.asarray(rgba, np.uint8)
        for g, adv in _char_cells(s, nonascii):
            if scale != 1:
                g = np.repeat(np.repeat(g, scale, 0), scale, 1)
            gh, gw = g.shape
            x0, y0 = max(x, 0), max(y, 0)
            x1 = min(x + gw, self.width)
            y1 = min(y + gh, self.height)
            if x1 > x0 and y1 > y0:
                sub = g[y0 - y : y1 - y, x0 - x : x1 - x]
                self.rgba[y0:y1, x0:x1][sub] = col
            x += adv * scale
        return x

    def packed(self) -> np.ndarray:
        """(H, W) uint32 RGBA (R = low byte) — the production frame
        packing (device.finish_packed)."""
        v = self.rgba.astype(np.uint32)
        return v[..., 0] | (v[..., 1] << 8) | (v[..., 2] << 16) | (
            v[..., 3] << 24)


def _alpha_over_u8(dst, src):                   # 4 (h, w) int64 planes
    """Src-alpha-over on u8 channel planes (int64 values 0-255); dst
    alpha kept."""
    a = src[3].to(torch.float32) * (1.0 / 255.0)
    out = [torch.clamp(src[c].to(torch.float32) * a
                       + dst[c].to(torch.float32) * (1.0 - a) + 0.5,
                       0.0, 255.0).to(torch.int64) for c in range(3)]
    out.append(dst[3])
    return out


def _planes(packed_i32) -> list:
    """(h, w) int32 RGBA8 bits → four int64 channel planes (masked after
    the shift, which is arithmetic on a signed word)."""
    w = packed_i32.to(torch.int64) & 0xFFFFFFFF
    return [(w >> (8 * c)) & 0xFF for c in range(4)]


def _band_rows(frame, overlay, y0: int) -> int:
    h = overlay.shape[0]
    if y0 < 0 or y0 + h > frame.shape[0] or overlay.shape[1] != frame.shape[1]:
        raise ValueError(
            f"overlay band {tuple(overlay.shape)} at row {y0} does not fit "
            f"the frame {tuple(frame.shape[:2])}")
    return h


def _composite_packed(frame_i32, overlay_i32, y0: int = 0):
    """Src-alpha-over of a packed overlay band onto a packed frame at
    row offset ``y0`` — shift/mask + f32 blend on (h, W) planes. Returns
    a new frame; the input is not written."""
    h = _band_rows(frame_i32, overlay_i32, y0)
    out = _alpha_over_u8(_planes(frame_i32[y0:y0 + h]), _planes(overlay_i32))
    p = out[0] | (out[1] << 8) | (out[2] << 16) | (out[3] << 24)
    packed = torch.where(p >= 2**31, p - 2**32, p).to(torch.int32)
    if h == frame_i32.shape[0]:
        return packed
    frame = frame_i32.clone()
    frame[y0:y0 + h] = packed
    return frame


def _composite_u8(frame_hwc, overlay_i32, y0: int = 0):
    """Same composite for unpacked (H, W, 4) uint8 frames (the texture
    view): channel slices in, one stacked write-back band out."""
    h = _band_rows(frame_hwc, overlay_i32, y0)
    band = frame_hwc[y0:y0 + h]
    dst = [band[..., c].to(torch.int64) for c in range(4)]
    out = _alpha_over_u8(dst, _planes(overlay_i32))
    frame = frame_hwc.clone()
    frame[y0:y0 + h] = torch.stack([o.to(torch.uint8) for o in out], -1)
    return frame


class GuiOverlay:
    """App-facing GUI layer: a canvas (full frame or a horizontal band)
    plus the device composite. The canvas re-uploads lazily — static
    overlays cost one upload; per-frame HUDs re-upload only their band,
    once per ``touch()``.
    """

    def __init__(self, width: int, height: int, y0: int = 0):
        self.canvas = GuiCanvas(width, height)
        self.y0 = int(y0)
        self._dev = None
        self._dirty = True

    def touch(self) -> None:
        """Mark the canvas changed (call after drawing)."""
        self._dirty = True

    def apply(self, frame):
        """Composite onto ``frame`` — packed (H, W) 32-bit RGBA8 bits or
        unpacked (H, W, 4) u8, a tensor on any device or a NumPy array;
        returns a tensor of the same format on the frame's device."""
        if not isinstance(frame, torch.Tensor):
            a = np.ascontiguousarray(frame)
            frame = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                     else a)
        if self._dirty or self._dev.device != frame.device:
            self._dev = torch.from_numpy(
                self.canvas.packed().view(np.int32)).to(frame.device)
            self._dirty = False
        if frame.dim() == 2:
            return _composite_packed(frame, self._dev, y0=self.y0)
        return _composite_u8(frame, self._dev, y0=self.y0)


def draw_gmd_message(canvas: GuiCanvas, gmd, label_or_index, x: int,
                     y: int, rgba=(255, 255, 80, 255),
                     scale: int = 1, nonascii: str = "box") -> int:
    """Draw one GMD message (by label string or message index) —
    the GUI-side consumer of ``formats.gmd.GuiMessageFile``. Multi-line
    messages split on ``\\n``/``\\r\\n``. Non-ASCII text (the engine's
    message tables are Japanese) renders under the ``nonascii`` policy
    (see ``GuiCanvas.draw_text``). Returns the y just past the last
    line."""
    if isinstance(label_or_index, int):
        text = gmd.messages[label_or_index].message
    else:
        text = next(m.message for m in gmd.messages
                    if m.label == label_or_index)
    for line in text.replace("\r\n", "\n").split("\n"):
        canvas.draw_text(x, y, line, rgba=rgba, scale=scale,
                         nonascii=nonascii)
        y += (GLYPH_H + 1) * scale
    return y
