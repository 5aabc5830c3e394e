"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each kernel is a plain ``extern "C"`` launcher compiled into its own
shared library: no PyTorch headers, so a build takes seconds. Libraries
are cached under ``<repo>/build/torch_kernels/`` by a hash of the
sources and flags, and built at first use — never at import.
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
# stay IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str, sources: list[str]) -> Path:
    """Compile ``csrc/<sources>`` into ``lib<name>-<hash>.so`` unless a
    library built from the same sources and flags exists. Returns its
    path; the compiler's ``-Xptxas -v`` report sits beside it as
    ``.log``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update((CSRC / s).read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)          # atomic: concurrent builds agree
    return out


def load(name: str, sources: list[str]) -> ctypes.CDLL:
    """Build if needed and load the library (once per process)."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name, sources)))
    return _LOADED[name]


def ptxas_report(name: str, sources: list[str]) -> str:
    """The ``ptxas info`` lines (registers, shared memory, spills) of
    the library's last build."""
    log = build(name, sources).with_suffix(".log")
    return "\n".join(ln for ln in log.read_text().splitlines()
                     if "ptxas info" in ln)
