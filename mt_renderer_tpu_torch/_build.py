"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each kernel is a plain ``extern "C"`` launcher compiled into its own
shared library: no PyTorch headers, so a build takes seconds. Libraries
are cached under ``<repo>/build/torch_kernels/`` by a hash of the
sources, the shared headers and the flags, and built at first use —
never at import.

``KERNELS`` names every kernel of the package with its sources; ``fn``
binds one exported function with its ctypes signature.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"

# -fmad=false: no FMA contraction, so each a*x + b*y + c rounds exactly
# like the plain PyTorch version's separate ops (winner ids, z and tap
# addresses then compare bit for bit). No --use_fast_math: divisions
# and square roots stay IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# kernel name -> its csrc sources (each also depends on csrc/*.cuh)
KERNELS = {"raster_fwd": ["raster_fwd.cu"],
           "raster_fwd_ml": ["raster_fwd_ml.cu"],
           "raster_micro": ["raster_micro.cu"],
           "bilin_swar": ["bilin_swar.cu"]}

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str, sources: list[str]) -> Path:
    """The library path for ``sources``: keyed by a hash of the flags,
    the sources and every shared header under ``csrc/``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*sources, *sorted(p.name for p in CSRC.glob("*.cuh"))]:
        h.update((CSRC / s).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(specs: dict[str, list[str]] | None = None) -> dict[str, Path]:
    """Compile each ``name: csrc sources`` entry (default ``KERNELS``)
    into ``lib<name>-<hash>.so`` unless a library built from the same
    sources, headers and flags exists. The ``nvcc`` processes all start
    at once; every one is waited for before any failure raises. Returns
    the library paths; each compiler's ``-Xptxas -v`` report sits beside
    its library as ``.log``."""
    specs = KERNELS if specs is None else specs
    out = {name: _target(name, srcs) for name, srcs in specs.items()}
    procs = {}
    for name, srcs in specs.items():
        if out[name].exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / s) for s in srcs)]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
            continue
        out[name].with_suffix(".log").write_text(log)
        os.replace(tmp, out[name])    # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """Build kernel ``name`` if needed and load its library (once per
    process)."""
    if name not in _LOADED:
        path = build_all({name: KERNELS[name]})[name]
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]


def fn(name: str, symbol: str, argtypes: list):
    """The exported C function ``symbol`` of kernel ``name``'s library,
    with its argument types declared; it returns a cudaError_t (int)."""
    f = getattr(load(name), symbol)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def ptxas_report(name: str) -> str:
    """The ``ptxas`` report of kernel ``name``'s build: each kernel's
    registers, shared memory, stack frame and spill bytes."""
    log = build_all({name: KERNELS[name]})[name].with_suffix(".log")
    return "\n".join(ln for ln in log.read_text().splitlines()
                     if "Used" in ln or "spill" in ln
                     or "Compiling entry" in ln)
