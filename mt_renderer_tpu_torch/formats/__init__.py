"""Host-side binary format parsers/writers for MT Framework resources:
archives (arc), GUI message tables (gmd) and their script tags (script),
GUI layouts (gui, unimplemented as in the reference), shaders (mfx),
models (mod), materials (mrl), schedulers (sdl), shader packages (spkg),
textures (tex) and serialized objects (xfs)."""

from . import arc, gmd, gui, mfx, mod, mrl, script, sdl, spkg, tex, xfs

__all__ = ["arc", "gmd", "gui", "mfx", "mod", "mrl", "script", "sdl",
           "spkg", "tex", "xfs"]
