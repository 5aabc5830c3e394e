"""textureviewer — view a .tex file (headless: renders to PNG).

Reference contract (``src/bin/textureviewer.rs``): argv is a direct
``.tex`` path; the texture draws aspect-fit on a fullscreen quad with the
game's YCbCr swizzle decode (textureviewer.wgsl). Headless here: ``--out``
PNG instead of a window; ``--raw`` skips the YCbCr decode; ``--serve
PORT`` streams the view over HTTP (the window analog, like
modelviewer's) and ``--hud`` overlays the texture's header info. The
view renders on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from ..app.manager import RendererApp, RendererAppManager
from ..formats.tex import TextureFile
from ..render.texture_view import view_texture
from ..utils.png import write_png
from ._common import add_device_arg, resolve_device


class TextureViewerApp(RendererApp):
    """Aspect-fit texture view as a RendererApp — gives the second
    reference viewer the same frame-driver frontends as modelviewer
    (headless PNG, ``--serve`` HTTP stream, HUD)."""

    interactive = False
    show_hud = False
    hud_gmd = None
    hud_label = None
    _hud = None

    def __init__(self, tex_path: str, raw: bool = False, device="cuda"):
        self.tex_path = tex_path
        self.raw = raw
        self.device = device

    def setup(self, mgr: RendererAppManager) -> None:
        with open(self.tex_path, "rb") as f:
            tex = TextureFile(f.read())
        self.info = (f"{tex.width}x{tex.height} fmt={tex.format} "
                     f"levels={tex.level_count}")
        print(f"{self.tex_path}: {self.info}")
        rgba = torch.from_numpy(tex.decode_rgba8()).to(self.device)
        self._render = functools.partial(
            view_texture, rgba, width=mgr.width, height=mgr.height,
            ycbcr=not self.raw)

    def render(self, mgr: RendererAppManager):
        frame = self._render()
        if self.show_hud:
            if self._hud is None:
                from ..app.hud import Hud

                self._hud = Hud(mgr.width, gmd_path=self.hud_gmd,
                                gmd_label=self.hud_label)
            frame = self._hud.apply(mgr, frame, extra=self.info)
        return frame


def main(argv=None):
    p = argparse.ArgumentParser(prog="textureviewer", description=__doc__)
    p.add_argument("tex_path", help="path to a .tex file")
    p.add_argument("--out", default="texture.png", help="output PNG path")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--raw", action="store_true",
                   help="show raw RGBA (skip the YCbCr swizzle decode)")
    p.add_argument("--hud", action="store_true",
                   help="overlay the texture header info + fps band")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve the view over HTTP (window analog)")
    p.add_argument("--serve-host", default="127.0.0.1")
    p.add_argument("--serve-frames", type=int, default=None,
                   help="stop the server after N frames (smoke tests)")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    app = TextureViewerApp(args.tex_path, raw=args.raw, device=dev)
    app.show_hud = args.hud
    mgr = RendererAppManager(app, width=args.width, height=args.height)
    if args.serve is not None:
        from ..app.serve import FrameStreamServer

        srv = FrameStreamServer(mgr, host=args.serve_host, port=args.serve)
        print(f"serving texture view on http://{args.serve_host}:{srv.port}/")
        srv.serve(max_frames=args.serve_frames)
        print(f"served {mgr.frame_index} frame(s)")
        return mgr
    frame = mgr.run_headless(frames=1)
    write_png(args.out, np.asarray(frame))
    print(f"wrote {args.out}")
    return mgr


if __name__ == "__main__":
    main()
