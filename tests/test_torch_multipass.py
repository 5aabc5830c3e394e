"""Port vs reference: the multipass peel, and K1's ``zlow`` exclusion and
plain-attributes (``attrs``) epilogue that it runs.

K1 here is ``raster_fwd`` on CPU tensors, i.e. its plain version
(``raster_fwd_reference``) through the custom op; the CUDA kernel is held
to it bit for bit on the card by ``test_torch_gpu.py``. The JAX package
runs its Pallas kernel in interpret mode. Scenes: the glass demo scene
(16 instances, every other one translucent, the camera inside the cube
field, so that later layers cover pixels) with unit normals pointing
away from its centroid, so the lambert factor varies; the tri texel
pool where mipmapped.

Tolerances:
- K1 against ``pallas_raster.raster_pallas_fwd`` on the same columns and
  the same ``zlow``: winner ids and coverage exact, z within 1e-5; the
  planes the epilogues copy (tex, C, off, th, tw, the raw gradients)
  exact; the planes they evaluate (u/w, v/w, 1/w, the normal planes, the
  mtap u, v and gradients over Q) within 1e-5 relative or absolute (XLA's
  CPU backend contracts the plane sums into FMAs); the tap fractions within
  2e-3 and the tap addresses equal on 99.7% of pixels, as in
  ``test_torch_raster.py``;
- ``shade_fwd`` on JAX's attrs planes: at most 0.3% of pixels with a
  channel off by more than 1, and 99% within 1e-2;
- frames against JAX's multipass: coverage exact, depth within 1e-4
  (each side's own vertex stage and setup: the port's sums round in
  another order than XLA's HIGHEST matmul, and with the camera inside
  the field z/w magnifies it; on shared columns K1's z holds 1e-5),
  color under the golden rule (at most 0.3% of pixels with a channel off
  by more than 1);
- the port's multipass against its own ml peel on a scene whose
  surfaces lie further apart than PEEL_EPS (``tests/test_peeling.py:
  150``): bilinear bit for bit; mipmapped at most 1 off on at most 0.1%
  of pixels (the lit shade lights after the albedo multiply where the ml
  peel folds the factor into C); depth bit for bit;
- pass 0 of the multipass (L = 1) against the single-layer frame: bit
  for bit, color and depth.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.render import pallas_raster as pr
from mt_renderer_tpu.scene import demo as jdemo
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import engine as te
from mt_renderer_tpu_torch.render import raster as tr
from mt_renderer_tpu_torch.scene import demo
from torch_threads import one_thread  # noqa: F401

W, H = 128, 64
LAYERS = 2
GOLDEN_SHARE = 0.003


def golden_share(got_u8, want_u8) -> float:
    diff = np.abs(np.asarray(got_u8).astype(np.int32)
                  - np.asarray(want_u8).astype(np.int32))
    return float((diff.max(-1) > 1).mean())


def _glass_batch(mod, instances: int = 16):
    batch = mod.make_translucent(mod.build_demo_batch(
        instances=instances, skinned=True, subdiv=1), instances,
        fraction=0.5)
    c = batch.positions - batch.positions.mean(0)
    batch.normals = (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(
        np.float32)
    return batch


@pytest.fixture(scope="module")
def glass():
    batch = _glass_batch(demo)
    cam = demo.demo_camera(16, W, H)
    cam.position = cam.position * 0.3
    vp = np.asarray(cam.view_proj())
    bones = demo.demo_bone_mats(0.3)
    jbatch = _glass_batch(jdemo)
    return dict(batch=batch, jbatch=jbatch, vp=vp, bones=bones,
                ts=td.upload(batch, "tri", device="cpu"),
                js=jd.upload(jbatch, pool_mode="tri"))


def _cols(glass, lit: bool):
    """JAX's packed columns → (JAX (cols, bbox), n_attr, port cols (ncol,
    Tp), port bbox)."""
    js = glass["js"]
    bones = jnp.asarray(glass["bones"])
    clip = jd.vertex_stage(js, jnp.asarray(glass["vp"]), bones)
    cols, bbox, n_attr = jd.setup_packed_cols(js, clip, W, H, bone_mats=bones,
                                              lighting=lit)
    tcols = torch.from_numpy(np.ascontiguousarray(np.asarray(cols).T))
    tbbox = tuple(torch.tensor(np.asarray(b)) for b in bbox)
    return (cols, bbox), n_attr, tcols, tbbox


@pytest.fixture(scope="module")
def k1_case(glass):
    """Both setups, lit and unlit, and a ``zlow`` that excludes pass 0's
    winners (+inf where pass 0 covered nothing, -inf on one tile row):
    the first pass's depth + PEEL_EPS, tile-major, one array that both
    sides take."""
    out = {lit: _cols(glass, lit) for lit in (False, True)}
    tcols, tbbox = out[False][2:]
    pre = tr.prebin(tcols, tbbox, 0, 0, width=W, height=H)
    zb, ib = tr.raster_fwd(tcols, *pre[:3], (0, 0), width=W, height=H,
                           w_eps=td.W_EPS)[:2]
    zlow = torch.where(ib >= 0, zb + td.PEEL_EPS, float("inf")).numpy()
    zlow[:, :, :tr.TILE_W] = -np.inf
    return out, zlow, {}


def _jax_k1(k1_case, mode: str, lit: bool, zlow: bool) -> list:
    """JAX's K1 (interpret mode, tile-major) on the case's columns, once
    per (mode, lit, zlow) in this module."""
    out, zl, cache = k1_case
    key = (mode, lit, zlow)
    if key not in cache:
        jsetup, n_attr = out[lit][:2]
        light = td._light_unit() if lit and mode != "attrs" else None
        cache[key] = [np.asarray(x) for x in pr.raster_pallas_fwd(
            jsetup, None, 0, 0, width=W, height=H, interpret=True,
            n_attr=n_attr, w_eps=jd.W_EPS, flat=True,
            zlow=jnp.asarray(zl) if zlow else None, tap=mode == "tap",
            mtap=mode == "mtap", light=light)]
    return cache[key]


@pytest.mark.parametrize("mode,lit,zlow", [
    ("attrs", False, False), ("attrs", True, True), ("tap", False, True),
    ("mtap", True, True)])
def test_k1_zlow_and_attrs_match_jax_kernel(k1_case, mode, lit, zlow):
    out, zl, _ = k1_case
    tcols, tbbox = out[lit][2:]
    light = td._light_unit() if lit else None
    want = _jax_k1(k1_case, mode, lit, zlow)
    lists, glists, counts, n_over = tr.prebin(tcols, tbbox, 0, 0, width=W,
                                              height=H)
    got = tr.raster_fwd(tcols, lists, glists, counts, (0, 0), width=W,
                        height=H, w_eps=td.W_EPS, mode=mode, light=light,
                        zlow=torch.from_numpy(zl) if zlow else None)
    got = [x.numpy() for x in got]
    assert int(n_over) == int(want[-1]) == 0
    np.testing.assert_array_equal(got[1], want[1])
    cov = want[1][:, 0] >= 0
    assert 0.02 < cov.mean() < 0.98
    if zlow:
        # the exclusion bites: nothing where pass 0 covered nothing, and
        # no winner at or in front of pass 0's
        first = np.isfinite(zl[:, 0]) & (zl[:, 0] > -np.inf)
        assert not cov[~np.isfinite(zl[:, 0]) & (zl[:, 0] > 0)].any()
        assert (got[0][:, 0][cov & first] > zl[:, 0][cov & first]).all()
    np.testing.assert_allclose(got[0][:, 0][cov], want[0][:, 0][cov],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[0][:, 0][~cov], 1.0)
    g, w = got[2], want[2]
    assert g.shape == w.shape == ((W // 128) * (H // 16),
                                  tr.n_planes(mode, light), tr.P)
    if mode == "attrs":
        evaluated = [0, 1, 2] + ([12, 13, 14] if lit else [])
        copied = [i for i in range(g.shape[1]) if i not in evaluated]
        np.testing.assert_array_equal(g[:, copied], w[:, copied])
        np.testing.assert_allclose(g[:, evaluated], w[:, evaluated],
                                   rtol=1e-5, atol=1e-5)
    elif mode == "tap":
        assert (got[3] == want[3]).mean() >= 0.997
        np.testing.assert_allclose(g[:, :2], w[:, :2], rtol=0, atol=2e-3)
        np.testing.assert_array_equal(g[:, 2:], w[:, 2:])
    else:
        np.testing.assert_array_equal(g[:, 2:7], w[:, 2:7])
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_k2_refuses_the_attrs_epilogue(glass):
    _, _, tcols, tbbox = _cols(glass, False)
    pre = tr.prebin(tcols, tbbox, 0, 0, width=W, height=H)
    with pytest.raises(ValueError, match="K2 runs one of"):
        tr.raster_fwd_ml(tcols, *pre[:3], (0, 0), width=W, height=H,
                         layers=2, w_eps=td.W_EPS, opaque_cull=True,
                         mode="attrs")
    with pytest.raises(ValueError, match="zlow must be f32"):
        tr.raster_fwd(tcols, *pre[:3], (0, 0), width=W, height=H,
                      w_eps=td.W_EPS, zlow=torch.zeros(1, 1, tr.P))


@pytest.mark.parametrize("mipmap,lit", [(False, False), (True, False),
                                        (True, True)])
def test_shade_fwd_matches_jax(glass, k1_case, mipmap, lit):
    """``shade_fwd`` on JAX's attrs planes (tile-major: the shade is
    elementwise) against JAX's ``shade_fwd`` on the same planes."""
    _, ib, attrs, _ = _jax_k1(k1_case, "attrs", lit, lit)
    ts = glass["ts"] if mipmap else td.upload(glass["batch"], device="cpu")
    js = glass["js"] if mipmap else jd.upload(glass["jbatch"])
    # (n_tiles, planes, P) → (planes, n_tiles, P): JAX's shade indexes
    # planes first, over any pixel shape
    src, cov = jd.shade_fwd(js, jnp.asarray(np.moveaxis(attrs, 1, 0)),
                            jnp.asarray(ib[:, 0]), mipmap=mipmap,
                            lighting=lit)
    got, gcov = td.shade_fwd(ts, torch.from_numpy(attrs.copy()),
                             torch.from_numpy(ib[:, 0].copy()),
                             mipmap=mipmap, lighting=lit)
    cov = np.asarray(cov)
    np.testing.assert_array_equal(gcov.numpy(), cov)
    got = torch.stack(got, -1).numpy()
    want = np.moveaxis(np.asarray(src), 0, -1)
    d = np.abs(got - want)[cov]
    assert (d.max(-1) > 1).mean() <= GOLDEN_SHARE
    assert (d.max(-1) <= 1e-2).mean() >= 0.99
    assert cov.mean() > 0.02


@pytest.mark.parametrize("mipmap,lit", [(False, False), (False, True),
                                        (True, False), (True, True)])
def test_multipass_frame_matches_jax(glass, mipmap, lit):
    kw = dict(width=W, height=H, layers=LAYERS, peel_mode="multipass",
              mipmap=mipmap, lighting=lit)
    want, want_d = jd.render_frame_peeled(
        glass["js"], jnp.asarray(glass["vp"]), jnp.asarray(glass["bones"]),
        backend="pallas", **kw)
    want, want_d = np.asarray(want), np.asarray(want_d)
    got, got_d = td.render_frame_peeled(glass["ts"], glass["vp"],
                                        glass["bones"], **kw)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got_d.numpy() < 1.0, want_d < 1.0)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=0, atol=1e-4)
    assert 0.05 < (want_d < 1.0).mean()
    assert golden_share(got.numpy(), want) <= GOLDEN_SHARE


@pytest.fixture(scope="module")
def separated():
    """The reference's separated scene (``tests/test_peeling.py:138``):
    4 opaque demo instances at subdiv 1, 96x96; tri pool, unit normals."""
    batch = demo.build_demo_batch(instances=4, skinned=True, subdiv=1)
    c = batch.positions - batch.positions.mean(0)
    batch.normals = (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(
        np.float32)
    vp = np.asarray(demo.demo_camera(4, 96, 96).view_proj())
    return td.upload(batch, "tri", device="cpu"), vp, demo.demo_bone_mats(0.4)


@pytest.mark.parametrize("mipmap", [False, True])
@pytest.mark.parametrize("lit", [False, True])
def test_multipass_matches_ml_on_a_separated_scene(separated, mipmap, lit):
    scene, vp, bones = separated
    kw = dict(width=96, height=96, layers=LAYERS, mipmap=mipmap,
              lighting=lit)
    a, da = td.render_frame_peeled(scene, vp, bones, peel_mode="multipass",
                                   **kw)
    b, db = td.render_frame_peeled(scene, vp, bones, peel_mode="ml", **kw)
    assert torch.equal(da, db)
    if mipmap:
        d = (a.int() - b.int()).abs().amax(-1)
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-3
    else:
        assert torch.equal(a, b)
    assert float((da < 1.0).float().mean()) > 0.05


@pytest.mark.parametrize("mipmap,lit", [(False, False), (False, True),
                                        (True, False)])
def test_pass0_equals_the_single_layer_frame(glass, mipmap, lit):
    """The multipass peel at L = 1 is the single-layer frame, bit for
    bit: the same K1 winners (zlow None), the same shade of the same
    planes, the same blend over the clear color."""
    kw = dict(width=W, height=H, mipmap=mipmap, lighting=lit)
    a, da = td.render_frame_peeled(glass["ts"], glass["vp"], glass["bones"],
                                   layers=1, peel_mode="multipass", **kw)
    b, db = td.render_frame(glass["ts"], glass["vp"], glass["bones"], **kw)
    assert torch.equal(a, b) and torch.equal(da, db)


def test_zlow_of_minus_inf_is_no_exclusion(glass):
    """A zlow of -inf everywhere gives K1's frame without one, bit for
    bit; +inf everywhere admits nothing."""
    _, _, tcols, tbbox = _cols(glass, False)
    pre = tr.prebin(tcols, tbbox, 0, 0, width=W, height=H)
    kw = dict(width=W, height=H, w_eps=td.W_EPS)
    base = tr.raster_fwd(tcols, *pre[:3], (0, 0), **kw)
    shape = (pre[2].shape[0], 1, tr.P)
    lo = tr.raster_fwd(tcols, *pre[:3], (0, 0),
                       zlow=torch.full(shape, -float("inf")), **kw)
    for x, y in zip(base, lo):
        assert torch.equal(x, y)
    hi = tr.raster_fwd(tcols, *pre[:3], (0, 0),
                       zlow=torch.full(shape, float("inf")), **kw)
    assert bool((hi[1] == -1).all()) and bool((hi[0] == 1.0).all())


def test_multipass_checks_and_engine(glass):
    ts, vp, bones = glass["ts"], glass["vp"], glass["bones"]
    kw = dict(width=W, height=H, peel_mode="multipass")
    with pytest.raises(ValueError, match="packed peeled output"):
        td.render_frame_peeled(ts, vp, bones, packed=True, **kw)
    with pytest.raises(ValueError, match="cap pair"):
        td.render_frame_peeled(ts, vp, bones, tap_tiles=(8, 8), **kw)
    eng = te.FrameEngine(ts, glass["batch"], width=W, height=H, peel=2,
                         peel_mode="multipass", mipmap=True, lighting=True)
    assert not eng.packed
    got, got_d = eng.render(vp, bones)
    assert eng.tap_tiles is None and eng.maxc
    want, want_d = td.render_frame_peeled(ts, vp, bones, layers=2,
                                          maxc=eng.maxc, mipmap=True,
                                          lighting=True, **kw)
    assert torch.equal(got, want) and torch.equal(got_d, want_d)
    eng.check(vp, bones)
    tr.flush_overflow_checks()
