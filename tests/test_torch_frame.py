"""Port vs reference: the whole packed frame, the goldens and the frame
loop.

The port's ``render_frame(packed=True)`` against JAX
``render_frame(backend="pallas", packed=True)`` (Pallas in interpret
mode), each from its own vertex stage. Tolerances: coverage exact;
winner ids equal on >= 99.9% of pixels; color under the golden rule —
at most 0.3% of pixels with a channel off by more than 1 (plane sums and
the bilinear contraction round in another order than XLA's)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.render import pallas_raster as pr
from mt_renderer_tpu.scene import demo
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import engine as te
from mt_renderer_tpu_torch.render import raster as tr

W, H = 256, 128
GOLDEN_DIR = Path(__file__).parent / "golden"


def golden_ok(got_u8, want_u8) -> float:
    """Share of pixels with a channel off by more than 1."""
    diff = np.abs(got_u8.astype(np.int32) - want_u8.astype(np.int32))
    return float((diff.max(-1) > 1).mean())


@pytest.fixture(scope="module")
def case():
    batch = demo.build_demo_batch(instances=9, skinned=True, subdiv=1)
    vp = np.asarray(demo.demo_camera(9, W, H).view_proj())
    bones = demo.demo_bone_mats(0.5)
    return (batch, vp, bones, jd.upload(batch),
            td.upload(batch, device="cpu"),
            td.auto_maxc(batch, vp, bones, width=W, height=H),
            td.auto_tap_tiles(batch, vp, bones, width=W, height=H))


@pytest.mark.parametrize("caps", ["dense", "auto"])
def test_packed_frame_matches_jax(case, caps):
    batch, vp, bones, js, ts, maxc, _ = case
    tap_tiles = None
    if caps == "auto":
        # pulled back so that some tile rows hold no textured chunk and
        # the tap really compacts
        cam = demo.demo_camera(9, W, H)
        cam.position = cam.position * 1.6
        vp = np.asarray(cam.view_proj())
        maxc = td.auto_maxc(batch, vp, bones, width=W, height=H)
        tap_tiles = td.auto_tap_tiles(batch, vp, bones, width=W, height=H)
        assert tap_tiles == jd.auto_tap_tiles(batch, vp, bones, width=W,
                                              height=H)
        assert tap_tiles < (W // tr.TILE_W) * (H // tr.TILE_H)
    want, wdepth = jd.render_frame(js, vp, bones, width=W, height=H,
                                   backend="pallas", packed=True,
                                   maxc=maxc, tap_tiles=tap_tiles)
    got, depth = td.render_frame(ts, vp, bones, width=W, height=H,
                                 packed=True, maxc=maxc,
                                 tap_tiles=tap_tiles)
    pr.flush_overflow_checks()
    tr.flush_overflow_checks()
    assert got.dtype == torch.int32 and tuple(got.shape) == (H, W)
    want = np.asarray(want)
    got_u32 = got.numpy().view(np.uint32)
    cov = np.asarray(wdepth) < 1.0
    np.testing.assert_array_equal(depth.numpy() < 1.0, cov)
    assert 0.05 < cov.mean() < 0.95
    assert golden_ok(td.unpack_rgba(got), jd.unpack_rgba(want)) <= 0.003
    assert (got_u32 == want).mean() > 0.99


def test_winner_ids_match_jax(case):
    batch, vp, bones, js, ts, maxc, _ = case
    clip = jd.vertex_stage(js, jnp.asarray(vp), jnp.asarray(bones))
    cols, bbox, n_attr = jd.setup_packed_cols(js, clip, W, H)
    _, want, _, _, _ = pr.raster_pallas_fwd(
        (cols, bbox), None, 0, 0, width=W, height=H, maxc=maxc,
        interpret=True, n_attr=n_attr, tap=True, w_eps=jd.W_EPS, flat=True)
    tcols, tbbox = td.setup_packed_cols(ts, td.vertex_stage(ts, vp, bones),
                                        W, H)
    lists, glists, counts, _ = tr.prebin(tcols, tbbox, 0, 0, width=W,
                                         height=H, maxc=maxc)
    _, got, _, _ = tr.raster_fwd(tcols, lists, glists, counts, (0, 0),
                                 width=W, height=H, w_eps=td.W_EPS)
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy() >= 0, want >= 0)
    assert (got.numpy() == want).mean() >= 0.999


def test_unpacked_is_a_view_of_packed(case):
    _, vp, bones, _, ts, maxc, taps = case
    packed, _ = td.render_frame(ts, vp, bones, width=W, height=H,
                                packed=True, maxc=maxc, tap_tiles=taps)
    rgba, _ = td.render_frame(ts, vp, bones, width=W, height=H,
                              maxc=maxc, tap_tiles=taps)
    assert rgba.dtype == torch.uint8 and tuple(rgba.shape) == (H, W, 4)
    np.testing.assert_array_equal(rgba.numpy(), td.unpack_rgba(packed))


def test_unpacked_frame_shades_dense_like_jax(case):
    """The unpacked bilinear frame ignores ``tap_tiles`` and queues the
    bins count alone, as the reference's does (its dense ``shade_tap``,
    ``mt_renderer_tpu/render/device.py:2881-2893``): with a cap far below
    the live rows it equals the dense frame bit for bit, queues no tap
    overflow, and matches JAX's frame at the same cap (coverage exact,
    the golden rule on color)."""
    _, vp, bones, js, ts, maxc, taps = case
    low = 1
    assert low < taps
    tr.flush_overflow_checks()          # what earlier frames queued
    before = tr.OVERFLOW_EVENTS
    got, depth = td.render_frame(ts, vp, bones, width=W, height=H,
                                 maxc=maxc, tap_tiles=low)
    dense, _ = td.render_frame(ts, vp, bones, width=W, height=H, maxc=maxc)
    counts = tr.flush_overflow_counts()
    assert not any(what.startswith("tap") for what in counts), counts
    assert all(n == 0 for n, _ in counts.values()), counts
    assert tr.OVERFLOW_EVENTS == before
    assert got.dtype == torch.uint8 and torch.equal(got, dense)
    want, wdepth = jd.render_frame(js, vp, bones, width=W, height=H,
                                   backend="pallas", maxc=maxc,
                                   tap_tiles=low)
    pr.flush_overflow_checks()
    np.testing.assert_array_equal(depth.numpy() < 1.0,
                                  np.asarray(wdepth) < 1.0)
    assert golden_ok(got.numpy(), np.asarray(want)) <= 0.003


def test_pack_bits_match_jax():
    """Equal float channels pack to equal u32 bits (alpha >= 128 sets
    the sign bit of the port's int32)."""
    rng = np.random.default_rng(2)
    ch = [rng.uniform(-5, 300, 4096).astype(np.float32) for _ in range(4)]
    want = np.asarray(jd.pack_u32_channels([jnp.asarray(c) for c in ch]))
    got = td.pack_u32_channels([torch.from_numpy(c) for c in ch])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_fixture_golden():
    """tests/golden/fixture_scene_96.npz under the golden rule."""
    want = np.load(GOLDEN_DIR / "fixture_scene_96.npz")["color"]
    batch = demo.build_demo_batch(instances=4, skinned=True, subdiv=2)
    vp = np.asarray(demo.demo_camera(4, 96, 96).view_proj())
    got, _ = td.render_frame(td.upload(batch, device="cpu"), vp,
                             demo.demo_bone_mats(0.6), width=96, height=96)
    assert golden_ok(got.numpy(), want) <= 0.003


def test_archive_golden(tmp_path):
    """tests/golden/archive_scene_192x96.npz: every model of the fixture
    archive plus the joint-cube overlay (scene built by the reference's
    sceneviewer), under the golden rule."""
    from mt_renderer_tpu import fixtures
    from mt_renderer_tpu.app.camera import Camera
    from mt_renderer_tpu.cli._common import load_shader2
    from mt_renderer_tpu.cli.sceneviewer import build_archive_scene
    from mt_renderer_tpu.resources import ResourceManager

    fixtures.write_fixture_tree(tmp_path)
    rm = ResourceManager(tmp_path)
    batch, _ = build_archive_scene(rm, "fixture_scene", load_shader2(rm),
                                   overlay=True)
    lo, hi = batch.positions.min(0), batch.positions.max(0)
    radius = float(np.linalg.norm(hi - lo)) / 2 + 1e-3
    cam = Camera(position=(lo + hi) / 2 + [0, radius * 0.4, radius * 2.0],
                 pitch=-10.0, far=max(50.0, radius * 8))
    cam.aspect = 192 / 96
    got, _ = td.render_frame(td.upload(batch, device="cpu"),
                             np.asarray(cam.view_proj()), width=192,
                             height=96)
    want = np.load(GOLDEN_DIR / "archive_scene_192x96.npz")["color"]
    assert golden_ok(got.numpy(), want) <= 0.003


def test_empty_scene():
    batch = demo.build_demo_batch(instances=1, skinned=False)
    batch.tris = batch.tris[:0]
    batch.tri_texture = batch.tri_texture[:0]
    batch.tri_parts = batch.tri_parts[:0]
    batch.tri_debug_id = batch.tri_debug_id[:0]
    vp = np.asarray(demo.demo_camera(1, 128, 64).view_proj())
    c, d = td.render_frame(td.upload(batch, device="cpu"), vp, None,
                           width=128, height=64)
    assert (c.numpy() == 255).all()
    assert (d.numpy() == 1.0).all()


def test_unaligned_resolution_pads_and_crops(case):
    _, vp, bones, _, ts, _, _ = case
    c, d = td.render_frame(ts, vp, bones, width=200, height=100)
    assert tuple(c.shape) == (100, 200, 4) and tuple(d.shape) == (100, 200)
    assert (d.numpy() < 1.0).any()


@pytest.mark.parametrize("kw", [dict(backend="scan")])
def test_unported_options_raise(case, kw):
    _, vp, bones, _, ts, _, _ = case
    with pytest.raises(NotImplementedError, match="not ported"):
        td.render_frame(ts, vp, bones, width=W, height=H, **kw)


def test_frame_engine_renders_the_production_frame(case):
    batch, vp, bones, _, ts, maxc, taps = case
    cam = demo.demo_camera(9, W, H)
    eng = te.FrameEngine(ts, batch, width=W, height=H, check_every=2)
    before = tr.OVERFLOW_EVENTS
    for t in range(3):
        cam.yaw = 15.0 + 2.0 * t
        fvp = np.asarray(cam.view_proj())
        fb = demo.demo_bone_mats(0.3 * t)
        got, _ = eng.render(fvp, fb)
        want, _ = td.render_frame(ts, fvp, fb, width=W, height=H,
                                  packed=True, maxc=eng.maxc,
                                  tap_tiles=eng.tap_tiles)
        assert torch.equal(got, want)
    eng.check()
    tr.flush_overflow_checks()
    assert tr.OVERFLOW_EVENTS == before
    assert eng.maxc >= maxc and eng.tap_tiles >= taps


def test_frame_engine_recovers_from_overflow(case):
    batch, vp, bones, _, ts, _, _ = case
    eng = te.FrameEngine(ts, batch, width=W, height=H)
    eng.size(vp, bones)
    old = eng.maxc
    tr.queue_overflow_check(torch.tensor(3, dtype=torch.int32), old)
    counts = eng.check(vp, bones)
    assert counts[tr._WHAT_BINS] == (3, old)
    assert eng.maxc == 2 * old and eng.recoveries == 1


def test_frame_engine_peel_raises(case):
    """The peeled engine runs the single-pass peels; the multipass peel
    is not ported, by decision."""
    batch, _, _, _, ts, _, _ = case
    with pytest.raises(NotImplementedError, match="by decision"):
        te.FrameEngine(ts, batch, width=W, height=H, peel=2,
                       peel_mode="multipass")


def test_frame_profile_runs_at_a_small_size(capsys):
    """The profiling script behind PERF.md's breakdown rehearses on CPU
    tensors: every section prints, and the profiler says plainly that it
    saw no device."""
    from mt_renderer_tpu_torch import frame_profile

    assert frame_profile.main(
        ["--device", "cpu", "--instances", "4", "--subdiv", "1",
         "--width", "256", "--height", "128", "--views", "1",
         "--frames", "1", "--prof-frames", "1"]) == 0
    out = capsys.readouterr().out
    for head in ("scene: 48 tris", "host guard per frame", "stages ms:",
                 "binning:", "render_frame, caps fixed"):
        assert head in out
    assert "idle share not measured" in out
