"""Port vs reference: the archive world and its device animation.

The world (distinct parsed models, mixed texture sizes in one pool, one
material slot per instance, 8-weight skinned characters posed from the
``.sdl`` timeline) is built by each package from the same seed; each
renders its own build with its own animated palette (the port's
computed by ``bone_mats_device``, torch on the CPU) through the binned
raster, at 128 x 128: packed bilinear, mipmapped from the tri pool, the
bird's-eye view of the characters, and the build with more than 128
material slots. The JAX side is ``render_frame(backend="pallas")``
(Pallas in interpret mode).

Tolerances: coverage exact; color under the golden rule (at most 0.3% of
pixels with a channel off by more than 1: XLA contracts the plane sums
into FMAs, the port rounds each op). The verify legs of
``verify.world_legs`` hold on the CPU at a reduced frame size.
"""

import numpy as np
import pytest
import torch

from mt_renderer_tpu.app.camera import Camera
from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.render import pallas_raster as pr
from mt_renderer_tpu.scene import world as jworld
from mt_renderer_tpu_torch import entry, verify
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr
from torch_threads import one_thread  # noqa: F401

S = 128
GOLDEN_SHARE = 0.003
SMALL = dict(buildings=18, characters=3, variants=6, terrain_subdiv=3)
MANY_SLOTS = verify.WORLD_LEGS          # the reference's verify build


def golden_share(got_u8, want_u8) -> float:
    """Share of pixels with a channel off by more than 1."""
    diff = np.abs(got_u8.astype(np.int32) - want_u8.astype(np.int32))
    return float((diff.max(-1) > 1).mean())


def _birds_eye(buildings: int):
    """The reference's bird's-eye camera over the character row."""
    side = int(np.ceil(np.sqrt(buildings)))
    cam = Camera(position=[0.0, -side * 1.6 - 2.0, 9.0], far=120.0)
    return np.asarray(cam.view_proj())


def _verify_camera():
    """The reference's verify camera (``bench.py:299-300``): at the world
    camera, sub-pixel far-field buildings near z = 0.9997 resolve to
    other winners under another rounding of the depth planes."""
    cam = Camera(position=[0.0, -26.0, 8.0], yaw=0.0, pitch=-30.0,
                 far=120.0)
    return np.asarray(cam.view_proj())


def _both(kw, pool_mode, frame, view):
    """Each package's world, camera view and palette at ``frame``; the
    port's palette is computed with ``bone_mats_device``."""
    case = entry.world_case("cpu", width=S, height=S, pool_mode=pool_mode,
                            **kw)
    ws = jworld.build_world(**kw)
    js = jd.upload(ws.batch, pool_mode=pool_mode)
    vp = {"birds_eye": lambda: _birds_eye(kw["buildings"]),
          "verify": _verify_camera,
          "world": lambda: np.asarray(jworld.world_camera(
              S, S, buildings=kw["buildings"]).view_proj())}[view]()
    tpal = case.bone_mats_device(frame)
    jpal = ws.bone_palette(ws.animator().bone_mats(frame))
    assert isinstance(tpal, torch.Tensor)
    np.testing.assert_allclose(tpal.numpy(), jpal, atol=1e-5)
    return case, js, vp, tpal, jpal


@pytest.mark.parametrize("kw,pool,mipmap,view,frame", [
    (SMALL, "quad", False, "world", 12.0),
    (SMALL, "tri", True, "world", 5.0),
    (SMALL, "quad", False, "birds_eye", 12.0),
    (MANY_SLOTS, "quad", False, "verify", 12.0),
], ids=["packed", "mipmap", "characters", "over_128_slots"])
def test_world_frame_matches_jax(kw, pool, mipmap, view, frame):
    case, js, vp, tpal, jpal = _both(kw, pool, frame, view)
    maxc = td.auto_maxc(case.batch, vp, jpal, width=S, height=S)
    taps = td.auto_tap_tiles(case.batch, vp, jpal, width=S, height=S)
    fkw = dict(width=S, height=S, packed=True, mipmap=mipmap, maxc=maxc,
               tap_tiles=taps)
    want, wdepth = jd.render_frame(js, vp, jpal, backend="pallas", **fkw)
    got, depth = td.render_frame(case.scene, vp, tpal, **fkw)
    pr.flush_overflow_checks()
    tr.flush_overflow_checks()
    cov = np.asarray(wdepth) < 1.0
    assert 0.05 < cov.mean()
    np.testing.assert_array_equal(depth.numpy() < 1.0, cov)
    assert golden_share(td.unpack_rgba(got),
                        jd.unpack_rgba(np.asarray(want))) <= GOLDEN_SHARE
    if kw is MANY_SLOTS:
        assert case.world.info["materials"] > 128
        np.testing.assert_array_equal(case.scene.mat_color.numpy(),
                                      np.asarray(js.mat_color))


def test_palette_animates_on_the_characters():
    """Frames at scheduler frames 12 and 30 differ where the characters
    are, and the palette the frame loop computes stays a tensor."""
    case = entry.world_case("cpu", width=S, height=S, **SMALL)
    vp = _birds_eye(SMALL["buildings"])
    frames = [td.render_frame(case.scene, vp, case.bone_mats_device(f),
                              width=S, height=S, packed=True)[0]
              for f in (12.0, 30.0)]
    tr.flush_overflow_checks()
    assert bool((frames[0] != frames[1]).any())


def test_world_legs_hold_on_the_cpu():
    """``verify.world_legs`` at the reference's world size and a reduced
    frame: every leg passes (the mipmapped leg compares the CPU path with
    itself here; on the card it holds the kernel's frame to the plain
    raster's)."""
    r = verify.world_legs("cpu", width=128, height=72)
    assert r["materials"] > 128
    for leg in ("invariants", "world_packed", "world_mipmap_packed",
                "world_chars_packed", "palette_animates"):
        assert r[leg]["passed"], (leg, r[leg])
    assert r["passed"]


def test_frame_profile_runs_the_world(capsys):
    """``frame_profile --world --mipmap`` rehearses on CPU tensors with a
    few buildings: the palette computed on the device is a timed stage."""
    from mt_renderer_tpu_torch import frame_profile

    assert frame_profile.main(
        ["--device", "cpu", "--world", "--buildings", "2", "--mipmap",
         "--width", "128", "--height", "64", "--views", "1", "--frames",
         "1", "--prof-frames", "1"]) == 0
    out = capsys.readouterr().out
    for head in ("scene: world, ", "bone_mats_device", "raster_fwd (K1), "
                 "mtap", "shade_mip_tap_flat_channels"):
        assert head in out
