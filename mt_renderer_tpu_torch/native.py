"""ctypes binding of the port's native host codecs (``csrc/bcn_native.cpp``).

The port's own C++ source, holding only the BC1 and BC7 entry points
bound here: ``decode_bc1`` and ``encode_bc1`` (the bc1 pool's content
pipeline and asset decoding) and ``decode_bc7`` (``.tex`` decoding, and
the bc7 pool's bookkeeping of an asset's blocks), each to the format's
specification. The library is built with ``g++`` at first use into
``<repo>/build/native/``, keyed by a hash of the source and the flags; a
host without a compiler, or where the build fails, takes the NumPy path
(``render.bcn``) instead. ``available()`` reports which path is live.
This is host code at load time, no device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent
SRC = PKG_DIR / "csrc" / "bcn_native.cpp"
BUILD_DIR = PKG_DIR.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-pthread",)

_lib = None
_tried = False


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libbcn_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """Compile ``SRC`` into ``out`` (atomically: concurrent builds
    agree). False when there is no source or compiler, or it fails."""
    if not SRC.is_file():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        tmp.unlink(missing_ok=True)
        return False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    out = _target()
    if not out.is_file() and not _build(out):
        return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mtr_decode_bc1.restype = ctypes.c_int
    lib.mtr_decode_bc1.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_int, u8p]
    lib.mtr_encode_bc1.restype = ctypes.c_int
    lib.mtr_encode_bc1.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p,
                                   ctypes.c_int]
    lib.mtr_decode_bc7.restype = ctypes.c_int
    lib.mtr_decode_bc7.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_int, u8p, ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native library is built and loaded; False when the
    NumPy path serves instead."""
    return _load() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_bc1(data: bytes, width: int, height: int) -> np.ndarray:
    """BC1 → (H, W, 4) uint8; ``bcn.decode_bc1_numpy`` without the
    library."""
    from .render import bcn

    nblocks = ((width + 3) // 4) * ((height + 3) // 4)
    if len(data) < nblocks * 8:
        raise ValueError(f"BC1 data truncated: {len(data)} bytes < "
                         f"{nblocks * 8} needed for {width}x{height}")
    lib = _load()
    if lib is None:
        return bcn.decode_bc1_numpy(data, width, height)
    out = np.empty((height, width, 4), np.uint8)
    if lib.mtr_decode_bc1(bytes(data), width, height, _u8p(out)) != 0:
        return bcn.decode_bc1_numpy(data, width, height)
    return out


def encode_bc1(img) -> np.ndarray:
    """(H, W, 4) uint8 RGBA → (bh·bw, 8) uint8 BC1 blocks: the threaded
    native encoder, bit-exact with ``bcn.encode_bc1_numpy`` (the path
    without the library)."""
    from .render import bcn

    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 4:
        raise ValueError(f"expected (H, W, 4) u8, got {img.shape}")
    lib = _load()
    if lib is None:
        return bcn.encode_bc1_numpy(img)
    h, w = img.shape[:2]
    out = np.empty((((h + 3) // 4) * ((w + 3) // 4), 8), np.uint8)
    if lib.mtr_encode_bc1(_u8p(img), w, h, _u8p(out), 0) != 0:
        return bcn.encode_bc1_numpy(img)
    return out


def decode_bc7(data: bytes, width: int, height: int) -> np.ndarray:
    """BC7 → (H, W, 4) uint8, all 8 modes, threaded over blocks;
    ``bcn.decode_bc7_numpy`` without the library or where it fails."""
    from .render import bcn

    # bounds check before the native call: the C decoder derives the
    # block count from the dimensions and reads with no length check
    nblocks = ((width + 3) // 4) * ((height + 3) // 4)
    if len(data) < nblocks * 16:
        raise ValueError(f"BC7 data truncated: {len(data)} bytes < "
                         f"{nblocks * 16} needed for {width}x{height}")
    lib = _load()
    if lib is None:
        return bcn.decode_bc7_numpy(data, width, height)
    out = np.empty((height, width, 4), np.uint8)
    if lib.mtr_decode_bc7(bytes(data), width, height, _u8p(out), 0) != 0:
        return bcn.decode_bc7_numpy(data, width, height)
    return out
