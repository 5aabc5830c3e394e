"""Shared CLI helpers."""

import torch

from .. import dti
from ..formats.mfx import Shader2File
from ..resources import ResourceManager

# the engine's shader set lives at this well-known resource path
# (reference modelviewer.rs:78-80)
SHADER_RESOURCE = "custom_shaders/CustomShaderPackage"


def load_shader2(rm: ResourceManager) -> Shader2File:
    res = rm.get_resource_fancy(SHADER_RESOURCE, dti.from_name("rShader2"))
    return Shader2File(res.read())


def add_device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda; no "
                        "fallback: pass --device cpu to render on the CPU)")


def resolve_device(name: str) -> torch.device:
    """The ``--device`` argument as a torch device; a CUDA device on a
    host without one is an error, never a silent switch to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: no CUDA device is visible; the viewers do "
            "not fall back to the CPU (pass --device cpu to render there)")
    return dev

