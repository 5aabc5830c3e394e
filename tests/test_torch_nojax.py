"""The port runs where jax cannot be imported.

A fresh interpreter makes ``import jax`` fail, imports the port, renders
its ``entry()`` frame on the CPU, and checks that no module of jax was
loaded on the way."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib.abc
import sys


class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError(f"{name} is blocked: the port must not need it")


sys.meta_path.insert(0, NoJax())

import mt_renderer_tpu_torch
from mt_renderer_tpu_torch import entry
from mt_renderer_tpu_torch.render import engine, raster

fn, args = entry.entry("cpu")
color = fn(*args)
assert tuple(color.shape) == (256, 256), color.shape
assert (color != -1).any(), "entry frame is all clear color"
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
assert not loaded, loaded
print("ok")
"""


def test_port_imports_and_renders_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
