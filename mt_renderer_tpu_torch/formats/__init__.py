"""Host-side binary format parsers/writers for the MT Framework resources
the scene path reads: shaders (mfx), models (mod), materials (mrl),
textures (tex) and schedulers (sdl)."""

from . import mfx, mod, mrl, sdl, tex

__all__ = ["mfx", "mod", "mrl", "sdl", "tex"]
