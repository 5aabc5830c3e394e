"""Stats / message HUD — the app-layer consumer of ``scene.gui``.

The reference measures ``frame_time`` but never displays it
(renderer_app_manager.rs:162-165, exposed at :64-66); this HUD closes
that loop: a per-frame fps/frame-counter band plus optional GMD
message lines, drawn host-side into a small band canvas (the same
traffic class as per-frame uniforms) and composited on device
(``scene.gui.GuiOverlay``)."""

from __future__ import annotations

from ..scene import gui

_PAD = 4
_SCALE = 2
_LINE_H = (gui.GLYPH_H + 1) * _SCALE


class Hud:
    """A top-of-frame HUD band: fps line + optional GMD message."""

    def __init__(self, width: int, gmd_path: str | None = None,
                 gmd_label: str | None = None):
        self.msg_lines: list[str] = []
        if gmd_path is not None:
            from ..formats.gmd import GuiMessageFile

            with open(gmd_path, "rb") as f:
                g = GuiMessageFile.parse(f.read())
            if gmd_label is None:
                msg = g.messages[0].message if g.messages else ""
            else:
                try:
                    msg = next(m.message for m in g.messages
                               if m.label == gmd_label)
                except StopIteration:
                    raise SystemExit(
                        f"hud: no GMD label {gmd_label!r} in {gmd_path}")
            self.msg_lines = msg.replace("\r\n", "\n").split("\n")
        band_h = 2 * _PAD + _LINE_H * (1 + len(self.msg_lines))
        self.overlay = gui.GuiOverlay(width, band_h, y0=0)

    def apply(self, mgr, frame, extra: str = ""):
        """Redraw the band for this frame and composite onto ``frame``
        (packed 32-bit or unpacked u8 — same format out, on the frame's
        device)."""
        c = self.overlay.canvas
        c.clear()
        c.fill_rect(0, 0, c.width, c.height, (0, 0, 0, 150))
        fps = 1.0 / mgr.frame_time if mgr.frame_time > 0 else 0.0
        line = (f"{fps:6.1f} fps  frame {mgr.frame_index:5d}  "
                f"{mgr.width}x{mgr.height}")
        if extra:
            line += f"  {extra}"
        y = _PAD
        c.draw_text(_PAD, y, line, (255, 255, 255, 255), scale=_SCALE)
        for ml in self.msg_lines:
            y += _LINE_H
            c.draw_text(_PAD, y, ml, (255, 255, 80, 255), scale=_SCALE)
        self.overlay.touch()
        return self.overlay.apply(frame)
