"""Host-side binary format parsers/writers for the MT Framework resources
the scene path and the viewers read: archives (arc), GUI message tables
(gmd), shaders (mfx), models (mod), materials (mrl), schedulers (sdl),
shader packages (spkg), textures (tex) and serialized objects (xfs)."""

from . import arc, gmd, mfx, mod, mrl, sdl, spkg, tex, xfs

__all__ = ["arc", "gmd", "mfx", "mod", "mrl", "sdl", "spkg", "tex", "xfs"]
