"""Port vs reference: the peeled frame, mipmapped and lit.

``composite_peeled_mip_flat``, ``render_frame_peeled(mipmap=True,
lighting=True)`` in both peel modes and the peeled ``FrameEngine``, held
against the JAX package (Pallas in interpret mode) on the glass demo
scene (every 4th instance translucent, the camera inside the cube
field) with the tri texel pool and unit normals pointing away from its
centroid, so that the lambert factor varies. K2's mtap and lit
epilogues on their own: ``test_torch_k2_mtap.py``.

Tolerances:
- the peeled trilinear composite on JAX's mtap planes: at most 0.3% of
  pixels with a channel off by more than 1 (XLA's FMA contraction of the
  plane sums, and log2's last bit, can move a tap across a texel or mip
  boundary) and 99% within 1e-3; the port's dense and compacted
  composites bit for bit;
- frames: coverage exact, color under the golden rule (at most 0.3% of
  pixels with a channel off by more than 1); the caps the port measures
  equal JAX's;
- the split frame against the ml frame on an opaque scene, and the
  engine against ``render_frame_peeled`` with its caps: bit for bit.
"""

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
from torch_threads import one_thread  # noqa: F401

W, H = 256, 128
GOLDEN_SHARE = 0.003


def golden_share(got_u8, want_u8) -> float:
    """Share of pixels with a channel off by more than 1."""
    diff = np.abs(got_u8.astype(np.int32) - want_u8.astype(np.int32))
    return float((diff.max(-1) > 1).mean())


def with_normals(batch):
    """Unit normals pointing away from the batch's centroid."""
    c = batch.positions - batch.positions.mean(0)
    batch.normals = (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(
        np.float32)
    return batch


@pytest.fixture(scope="module")
def glass():
    """The lit glass scene with the tri pool on both sides, its view,
    bones and JAX's measured caps."""
    batch = with_normals(demo.make_translucent(demo.build_demo_batch(
        instances=12, skinned=True, subdiv=1), 12))
    cam = demo.demo_camera(12, W, H)
    cam.position = cam.position * 0.3
    vp, bones = np.asarray(cam.view_proj()), demo.demo_bone_mats(0.4)
    js = jd.upload(batch, pool_mode="tri")
    ts = td.upload(batch, "tri", device="cpu")
    caps = {mode: jd.measure_live_tap_tiles(
        js, vp, bones, width=W, height=H, layers=3, lighting=True,
        mode=mode) for mode in ("split", "ml")}
    return dict(batch=batch, vp=vp, bones=bones, js=js, ts=ts, caps=caps)


# ------------------------------------------------------------ composite


def test_composite_peeled_mip_matches_jax_on_the_same_planes(glass):
    """Both peeled trilinear composites on JAX's lit ml mtap planes of the
    glass scene, dense."""
    js = glass["js"]
    clip = jd.vertex_stage(js, jnp.asarray(glass["vp"]),
                           jnp.asarray(glass["bones"]))
    cols, bbox, n_attr = jd.setup_packed_cols(
        js, clip, W, H, bone_mats=jnp.asarray(glass["bones"]),
        lighting=True)
    _, il, mattrs, _ = pr.raster_pallas_fwd_ml(
        (cols, bbox), None, 0, 0, width=W, height=H, layers=3, maxc=16,
        interpret=True, n_attr=n_attr, mtap=True, w_eps=jd.W_EPS,
        light=td._light_unit(), flat=True)
    clear = (255, 255, 255, 255)
    want, _ = jd.composite_peeled_mip_flat(js, mattrs, il, 3, clear)
    got, n_over = td.composite_peeled_mip_flat(
        glass["ts"], torch.from_numpy(np.array(mattrs)),
        torch.from_numpy(np.array(il)), 3, clear)
    assert int(n_over) == 0
    g = np.stack([c.numpy() for c in got], -1)
    w = np.stack([np.asarray(c) for c in want], -1)
    assert (np.asarray(il)[:, 1] >= 0).any()
    err = np.abs(g - w).max(-1)
    assert float((err > 1.0).mean()) <= GOLDEN_SHARE
    assert float((err <= 1e-3).mean()) > 0.99


def test_composite_peeled_mip_dense_equals_compacted(glass):
    """The same ml mtap planes composited dense and through a cap that
    compacts: bit for bit, with no row over the cap."""
    ts, vp, bones = glass["ts"], glass["vp"], glass["bones"]
    cols, bbox = td.setup_packed_cols(ts, td.vertex_stage(ts, vp, bones),
                                      W, H, bone_mats=bones, lighting=True)
    pre = tr.prebin(cols, bbox, 0, 0, width=W, height=H, maxc=16)
    _, il, mattrs = tr.raster_fwd_ml(
        cols, *pre[:3], (0, 0), width=W, height=H, layers=3,
        w_eps=td.W_EPS, opaque_cull=True, mode="mtap",
        light=td._light_unit())
    cap = glass["caps"]["ml"]
    n = (W // tr.TILE_W) * (H // tr.TILE_H) * 3
    assert cap < n
    clear = (255, 255, 255, 255)
    dense, _ = td.composite_peeled_mip_flat(ts, mattrs, il, 3, clear)
    comp, n_over = td.composite_peeled_mip_flat(ts, mattrs, il, 3, clear,
                                                tap_tiles=cap)
    assert int(n_over) == 0
    for a, b in zip(dense, comp):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- frame


@pytest.mark.parametrize("mode", ["split", "ml"])
def test_peeled_mip_lit_frame_matches_jax(glass, mode):
    """``render_frame_peeled(mipmap=True, lighting=True, packed=True)``
    with the caps JAX measured (the port measures the same: checked
    here), against JAX's frame with those caps."""
    caps = glass["caps"][mode]
    kw = dict(width=W, height=H, layers=3, peel_mode=mode, packed=True,
              mipmap=True, lighting=True, tap_tiles=caps)
    want, wdepth = jd.render_frame_peeled(
        glass["js"], glass["vp"], glass["bones"], backend="pallas", **kw)
    pr.flush_overflow_checks()
    got, depth = td.render_frame_peeled(glass["ts"], glass["vp"],
                                        glass["bones"], **kw)
    tr.flush_overflow_checks()
    assert td.measure_live_tap_tiles(
        glass["ts"], glass["vp"], glass["bones"], width=W, height=H,
        layers=3, lighting=True, mode=mode) == caps
    assert got.dtype == torch.int32 and tuple(got.shape) == (H, W)
    cov = np.asarray(wdepth) < 1.0
    assert 0.2 < cov.mean() < 1.0
    np.testing.assert_array_equal(depth.numpy() < 1.0, cov)
    assert golden_share(td.unpack_rgba(got),
                        jd.unpack_rgba(np.asarray(want))) <= GOLDEN_SHARE


def test_peeled_mip_split_equals_ml_on_an_opaque_scene():
    """The reference's ``peel_split`` leg, mipmapped and lit: on an opaque
    scene the split frame (packed, measured caps) equals the ml frame
    (dense), color and depth bit for bit."""
    batch = with_normals(demo.build_demo_batch(instances=4, skinned=True,
                                               subdiv=1))
    vp = np.asarray(demo.demo_camera(4, 96, 96).view_proj())
    bones = demo.demo_bone_mats(0.4)
    ts = td.upload(batch, "tri", device="cpu")
    kw = dict(width=96, height=96, layers=3, mipmap=True, lighting=True)
    caps = td.measure_live_tap_tiles(ts, vp, bones, width=96, height=96,
                                     layers=3, lighting=True, mode="split")
    sp, sd = td.render_frame_peeled(ts, vp, bones, peel_mode="split",
                                    packed=True, tap_tiles=caps, **kw)
    ml, md = td.render_frame_peeled(ts, vp, bones, peel_mode="ml", **kw)
    tr.flush_overflow_checks()
    np.testing.assert_array_equal(td.unpack_rgba(sp), ml.numpy())
    assert torch.equal(sd, md) and bool((md < 1.0).any())


def test_peeled_engine_renders_the_mip_lit_frame(glass):
    """``FrameEngine(peel=3, mipmap=True, lighting=True)`` sizes its caps
    with the lit measurement and renders ``render_frame_peeled``'s frame
    at those caps, frame after frame."""
    batch, ts = glass["batch"], glass["ts"]
    for peel_mode in ("split", "ml"):
        eng = te.FrameEngine(ts, batch, width=W, height=H, peel=3,
                             peel_mode=peel_mode, mipmap=True,
                             lighting=True, check_every=2)
        before = tr.OVERFLOW_EVENTS
        cam = demo.demo_camera(12, W, H)
        cam.position = cam.position * 0.3
        for t in range(2):
            cam.yaw = 15.0 + 2.0 * t
            vp = np.asarray(cam.view_proj())
            bones = demo.demo_bone_mats(0.3 * t)
            got, _ = eng.render(vp, bones)
            if t == 0:
                assert eng.tap_tiles == td.measure_live_tap_tiles(
                    ts, vp, bones, width=W, height=H, layers=3,
                    maxc=eng.maxc, lighting=True, mode=peel_mode,
                    margin=eng.headroom)
            want, _ = td.render_frame_peeled(
                ts, vp, bones, width=W, height=H, layers=3, maxc=eng.maxc,
                peel_mode=peel_mode, packed=False, mipmap=True,
                lighting=True, tap_tiles=eng.tap_tiles,
                check_overflow=False)
            assert not eng.packed and got.dtype == torch.uint8
            assert torch.equal(got, want)
        eng.check()
        tr.flush_overflow_checks()
        assert tr.OVERFLOW_EVENTS == before


def test_frame_profile_runs_the_peeled_mip_lit_frame(capsys):
    """``frame_profile --translucent --peel L --mipmap --lighting``
    rehearses on CPU tensors: every stage of the split frame prints, and
    the profiler says plainly that it saw no device."""
    from mt_renderer_tpu_torch import frame_profile

    assert frame_profile.main(
        ["--device", "cpu", "--instances", "12", "--subdiv", "1",
         "--width", "256", "--height", "128", "--views", "1",
         "--frames", "1", "--prof-frames", "1", "--translucent",
         "--peel", "3", "--mipmap", "--lighting"]) == 0
    out = capsys.readouterr().out
    for head in ("peel=3, mipmap=True, lighting=True",
                 "raster_fwd (K1), mtap+lit, opaque set",
                 "raster_fwd_ml (K2), mtap+lit, translucent set",
                 "composite_peeled_mtap_flat", "opaque trilinear shade"):
        assert head in out
    assert "idle share not measured" in out


def test_engine_format_matches_jax():
    """``FrameEngine(backend="pallas", ...)``'s ``packed`` equals the JAX
    engine's (``mt_renderer_tpu/render/engine.py:91-98``) for the four
    (peel, mipmap) combinations, and so do the shape and dtype of its
    frame on a small glass scene with the tri pool against the frame the
    JAX engine renders (``jax.eval_shape`` of its call): the (H, W)
    packed frame, except the (H, W, 4) uint8 frame of a peel with
    ``mipmap``. The engines of the scan backend and of the multipass
    peel take the JAX engine's format too: the uint8 frame."""
    import jax

    from mt_renderer_tpu.render import engine as je

    batch = demo.make_translucent(demo.build_demo_batch(
        instances=4, skinned=True), 4, fraction=0.5)
    vp = np.asarray(demo.demo_camera(4, 64, 64).view_proj())
    bones = demo.demo_bone_mats(0.3)
    ts = td.upload(batch, "tri", device="cpu")
    js = jd.upload(batch, pool_mode="tri")
    for peel, mipmap in ((0, False), (0, True), (3, False), (3, True)):
        kw = dict(width=64, height=64, backend="pallas", peel=peel,
                  mipmap=mipmap)
        eng = te.FrameEngine(ts, batch, **kw)
        jeng = je.FrameEngine(js, batch, **kw)
        assert eng.packed == jeng.packed == (not (peel and mipmap))
        got, _ = eng.render(vp, bones)
        fkw = dict(width=64, height=64, backend="pallas", mipmap=mipmap,
                   packed=jeng.packed, check_overflow=False)
        if peel:
            want = jax.eval_shape(lambda: jd.render_frame_peeled(
                js, vp, bones, layers=peel, peel_mode="split", **fkw))[0]
        else:
            want = jax.eval_shape(lambda: jd.render_frame(js, vp, bones,
                                                          **fkw))[0]
        assert tuple(got.shape) == want.shape
        assert got.element_size() == want.dtype.itemsize
        assert (got.dtype == torch.uint8) == (want.dtype == np.uint8)
    tr.flush_overflow_checks()
    for extra in (dict(backend="scan", peel=0), dict(backend="scan"),
                  dict(peel_mode="multipass")):
        eng = te.FrameEngine(ts, batch, **dict(kw, **extra))
        jeng = je.FrameEngine(js, batch, **dict(kw, **extra))
        assert eng.packed == jeng.packed is False
