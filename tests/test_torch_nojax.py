"""The port runs where neither jax nor the JAX package can be imported.

A fresh interpreter makes ``import jax`` and ``import mt_renderer_tpu``
(with its submodules; ``mt_renderer_tpu_torch`` stays importable) fail,
imports the port and its two card tools, renders on the CPU its
``entry()`` frame, a small split-peel frame of the glass scene, a small
mipmapped, lit frame from the tri pool, the same scene's peeled
mipmapped, lit frame, the glass scene's multipass peel (bilinear, and
mipmapped and lit), scan frames (single, ``ml``-peeled, mipmapped and
lit, a bc1 pool without mipmap, the scan band split equal to the scan
frame), a small archive-world frame whose palette
``bone_mats_device`` computes, the same world's frames from the bc1
texel pool (its textures BC1-encoded through the port's own native
binding) and from the bc7 pool (mode-6 content), runs the reference
bench's verify legs (``verify.bench_legs``) at a small size, renders the
band split and the geometry split over three CPU slots (each equal to
the single-device frame) and the multi-device dry run
(``entry.dryrun_multichip``) at a small size, writes the
fixture tree and runs the three viewers on it with ``--device cpu``
(``modelviewer`` with the joint overlay and with the archive world and
its HUD, ``textureviewer``, ``sceneviewer``), serves a small frame
through ``serving.export_render``/``load_render`` (equal to
``render_frame``) under ``utils.profiling.trace`` (whose Chrome trace
names K1's op), runs the ``schedulerdump`` CLI on the fixture tree, and
checks that no module of jax or of the JAX package was loaded on the
way."""

import os
import subprocess
import sys
from pathlib import Path

from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib.abc
import sys

BLOCKED = ("jax", "jaxlib", "mt_renderer_tpu")


def blocked(name):
    return name.split(".")[0] in BLOCKED


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"{name} is blocked: the port must not need it")


sys.meta_path.insert(0, Block())

import torch

import mt_renderer_tpu_torch
from mt_renderer_tpu_torch import entry
from mt_renderer_tpu_torch.render import device, engine, raster
from mt_renderer_tpu_torch.tools import bilin_ab, raster_roofline

fn, args = entry.entry("cpu")
color = fn(*args)
assert tuple(color.shape) == (256, 256), color.shape
assert (color != -1).any(), "entry frame is all clear color"

glass = entry.demo_case("cpu", instances=12, width=256, height=128,
                        subdiv=1, translucent=True, cam_scale=0.3)
eng = engine.FrameEngine(glass.scene, glass.batch, width=256, height=128,
                         peel=3, peel_mode="split")
color, depth = eng.render(glass.view_proj(), glass.bone_mats(0.4))
assert tuple(color.shape) == (128, 256) and isinstance(eng.tap_tiles, tuple)
assert (depth < 1.0).any() and (color != -1).any()

mip = entry.demo_case("cpu", instances=4, width=256, height=128, subdiv=1,
                      pool_mode="tri")
eng = engine.FrameEngine(mip.scene, mip.batch, width=256, height=128,
                         mipmap=True, lighting=True)
color, depth = eng.render(mip.view_proj(), mip.bone_mats(0.2))
assert (depth < 1.0).any() and (color != -1).any()

peeled = entry.demo_case("cpu", instances=12, width=256, height=128,
                         subdiv=1, translucent=True, cam_scale=0.3,
                         pool_mode="tri")
eng = engine.FrameEngine(peeled.scene, peeled.batch, width=256, height=128,
                         peel=3, mipmap=True, lighting=True)
color, depth = eng.render(peeled.view_proj(), peeled.bone_mats(0.4))
assert not eng.packed and tuple(color.shape) == (128, 256, 4)
assert (depth < 1.0).any() and (color != 255).any()

for kw in (dict(), dict(mipmap=True, lighting=True)):
    color, depth = device.render_frame_peeled(
        peeled.scene, peeled.view_proj(), peeled.bone_mats(0.4), width=256,
        height=128, layers=3, peel_mode="multipass", **kw)
    assert tuple(color.shape) == (128, 256, 4) and (depth < 1.0).any()

scan = entry.demo_case("cpu", instances=4, width=64, height=48, subdiv=1,
                       pool_mode="bc1")
svp, sbones = scan.view_proj(), scan.bone_mats(0.2)
scan_quad = device.upload(scan.batch, device="cpu")
for sc, kw in ((scan_quad, dict()), (scan_quad, dict(layers=2)),
               (scan_quad, dict(mipmap=True, lighting=True)),
               (scan.scene, dict())):
    fn = device.render_frame_peeled if "layers" in kw else device.render_frame
    color, depth = fn(sc, svp, sbones, width=64, height=48, backend="scan",
                      **kw)
    assert color.dtype == torch.uint8 and (depth < 1.0).any()

world = entry.world_case("cpu", buildings=8, width=128, height=96,
                         characters=2, variants=3, terrain_subdiv=2,
                         building_subdivs=(1,))
palette = world.bone_mats_device(12.0)
color, depth = device.render_frame(world.scene, world.view_proj(), palette,
                                   width=128, height=96, mipmap=True,
                                   packed=True)
assert (depth < 1.0).any() and (color != -1).any()

bc1 = entry.world_case("cpu", buildings=8, width=128, height=96,
                       characters=2, variants=3, terrain_subdiv=2,
                       building_subdivs=(1,), pool_mode="bc1")
assert bc1.scene.pool_mode == "bc1"
color, depth = device.render_frame(bc1.scene, bc1.view_proj(),
                                   bc1.bone_mats_device(12.0), width=128,
                                   height=96, mipmap=True, packed=True)
assert (depth < 1.0).any() and (color != -1).any()

bc7 = entry.world_case("cpu", buildings=8, width=128, height=96,
                       characters=2, variants=3, terrain_subdiv=2,
                       building_subdivs=(1,), pool_mode="bc7")
assert bc7.scene.pool_mode == "bc7" and bc7.scene.bc7_modes == (6,)
color, depth = device.render_frame(bc7.scene, bc7.view_proj(),
                                   bc7.bone_mats_device(12.0), width=128,
                                   height=96, mipmap=True, packed=True)
assert (depth < 1.0).any() and (color != -1).any()
raster.flush_overflow_checks()

from mt_renderer_tpu_torch import verify

legs = verify.bench_legs("cpu", width=64, height=64, instances=4, subdiv=1)
assert legs["passed"], legs

import torch

from mt_renderer_tpu_torch.parallel import tiles

bands = entry.demo_case("cpu", instances=4, width=64, height=60, subdiv=1)
bvp, bbones = bands.view_proj(), bands.bone_mats(0.7)
want = device.render_frame(bands.scene, bvp, bbones, width=64, height=60,
                           packed=True)
for split in (tiles.render_frame_multichip, tiles.render_frame_geomsplit):
    got = split(bands.scene, bvp, bbones, width=64, height=60, packed=True,
                mesh=tiles.make_row_mesh(3, device="cpu"))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
want = device.render_frame(bands.scene, bvp, bbones, width=64, height=60,
                           backend="scan")
got = tiles.render_frame_multichip(bands.scene, bvp, bbones, width=64,
                                   height=60, backend="scan",
                                   mesh=tiles.make_row_mesh(3, device="cpu"))
assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
dry = entry.dryrun_multichip(2, "cpu", width=128, height=64, instances=4,
                             subdiv=1, buildings=8, world_width=64,
                             world_height=32)
assert dry["overflow_events"] == 0, dry

import pathlib
import tempfile

from mt_renderer_tpu_torch import fixtures
from mt_renderer_tpu_torch.cli import modelviewer, sceneviewer, textureviewer

with tempfile.TemporaryDirectory() as tmp:
    root = pathlib.Path(tmp)
    fixtures.write_fixture_tree(root)
    cpu = ["--device", "cpu", "--width", "48", "--height", "48"]
    modelviewer.main([str(root),
                      str(root / "chara/fixture_character_skinned.chr"),
                      "--overlay", "--out", str(root / "mv.png"), *cpu])
    modelviewer.main(["--demo", "2", "--hud", "--out", str(root / "w.png"),
                      *cpu])
    textureviewer.main([str(root / "model/fixture_albedo.tex"),
                        "--out", str(root / "t.png"), *cpu])
    sceneviewer.main([str(root), "fixture_scene", "--overlay",
                      "--out", str(root / "s.png"), *cpu])
    for name in ("mv.png", "w.png", "t.png", "s.png"):
        assert (root / name).read_bytes().startswith(b"\x89PNG"), name

import contextlib
import io

import torch

from mt_renderer_tpu_torch import serving
from mt_renderer_tpu_torch.cli import schedulerdump
from mt_renderer_tpu_torch.utils import profiling

small = entry.demo_case("cpu", instances=4, width=64, height=64, subdiv=1)
vp, bones = small.view_proj(), small.bone_mats(0.3)
art = serving.load_render(serving.export_render(small.scene, width=64,
                                                height=64))
color, depth = art(small.scene, vp, bones)
want, wdepth = device.render_frame(small.scene, vp, bones, width=64,
                                   height=64)
assert torch.equal(color, want) and torch.equal(depth, wdepth)
with tempfile.TemporaryDirectory() as tmp:
    with profiling.trace(tmp) as log_dir:
        art(small.scene, vp, bones)
    text = (pathlib.Path(log_dir) / profiling.TRACE_FILE).read_text()
    assert "mtr::raster_fwd_tap" in text
    root = pathlib.Path(tmp)
    fixtures.write_fixture_tree(root)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        schedulerdump.main([str(root / "motion/fixture_timeline.sdl")])
    assert "mAlpha" in out.getvalue()
raster.flush_overflow_checks()

loaded = sorted(m for m in sys.modules if blocked(m))
assert not loaded, loaded
print("ok")
"""


def test_port_imports_and_renders_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          env=dict(os.environ, OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
