"""Port vs reference: the scan backend, the JAX package's second renderer
and its independent oracle (every triangle against every pixel, z from
barycentrics, the shade from per-triangle tables).

The same seeded scene goes through the JAX package's plain XLA scan and
the port's plain PyTorch one: the demo scene (16 instances at subdiv 1,
every other one translucent, the camera inside the field so that pixels
see several layers) with unit normals pointing away from its centroid,
at 96x64 (the scan backend needs no tile alignment). Stages run on JAX's
own setup (converted to tensors), so each compares one stage's
arithmetic.

Tolerances:
- ``setup_stage``: flags exact, coefficients within 1e-5 relative (the
  port's vertex stage sums in another order than XLA's HIGHEST matmul);
- ``raster_stage`` and ``raster_multilayer`` on JAX's setup: coverage
  exact; winner ids exact except where two candidates tie in z within
  1e-6 (XLA's einsum and the port's sum round the three products in
  another order, so an exact tie on one side may be an ulp apart on the
  other); depth within 1e-4 (the barycentrics of a sliver seen from
  inside the field are large, and their cancellation magnifies that
  rounding); the peeled raster (``zlow``) behind each side's own first
  layer;
- ``shade_src`` on JAX's setup and winners, and the samplers on seeded
  (layer, u, v, lod): at most 0.3% of pixels with a channel off by more
  than 1 and 99% within 1e-2 (shade), every sample within 1e-3
  (samplers: the bilinear contraction sums its four corners in another
  order);
- frames: coverage exact, depth within 1e-4 (each side's own vertex
  stage, as in ``test_torch_multipass.py``), color under the golden rule
  (at most 0.3% of pixels with a channel off by more than 1);
- the band and geometry splits and ``FrameEngine(backend="scan")``
  against the port's scan frame: bit for bit (integer paths and the same
  float ops in the same order).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.scene import demo as jdemo
from mt_renderer_tpu_torch.parallel import tiles
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import engine as te
from mt_renderer_tpu_torch.scene import demo
from torch_threads import one_thread  # noqa: F401

W, H = 96, 64
CHUNK = td.DEFAULT_CHUNK
GOLDEN_SHARE = 0.003


def golden_share(got_u8, want_u8) -> float:
    diff = np.abs(np.asarray(got_u8).astype(np.int32)
                  - np.asarray(want_u8).astype(np.int32))
    return float((diff.max(-1) > 1).mean())


def _batch(mod):
    batch = mod.make_translucent(mod.build_demo_batch(
        instances=16, skinned=True, subdiv=1), 16, fraction=0.5)
    c = batch.positions - batch.positions.mean(0)
    batch.normals = (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(
        np.float32)
    return batch


@pytest.fixture(scope="module")
def case():
    batch, jbatch = _batch(demo), _batch(jdemo)
    cam = demo.demo_camera(16, W, H)
    cam.position = cam.position * 0.3
    vp = np.asarray(cam.view_proj())
    bones = demo.demo_bone_mats(0.3)
    js = jd.upload(jbatch)
    jclip = jd.vertex_stage(js, jnp.asarray(vp), jnp.asarray(bones))
    jsetup = jd.setup_stage(js, jclip, W, H, bone_mats=jnp.asarray(bones),
                            need_normals=True)
    tsetup = {k: torch.from_numpy(np.array(v)) for k, v in jsetup.items()}
    return dict(batch=batch, jbatch=jbatch, vp=vp, bones=bones, js=js,
                ts=td.upload(batch, device="cpu"), jsetup=jsetup,
                tsetup=tsetup, scenes={})


def scenes(case, pool: str):
    """(port scene, JAX scene) with the ``pool`` texel pool, built once."""
    if pool not in case["scenes"]:
        case["scenes"][pool] = (td.upload(case["batch"], pool, device="cpu"),
                                jd.upload(case["jbatch"], pool_mode=pool))
    return case["scenes"][pool]


def test_setup_stage_matches_jax(case):
    got = td.setup_stage(case["ts"], td.vertex_stage(case["ts"], case["vp"],
                                                     case["bones"]),
                         W, H, bone_mats=case["bones"], need_normals=True)
    assert set(got) <= set(case["jsetup"])
    for k, g in got.items():
        w = np.asarray(case["jsetup"][k])
        g = g.numpy()
        assert g.shape == w.shape, k
        if g.dtype == bool:
            assert (g == w).mean() >= 0.999, k
        else:
            scale = np.abs(w).max()
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=k)


def _hold_winners(got_z, got_i, want_z, want_i):
    """Coverage exact; ids exact except at z ties within 1e-6; depth
    within 1e-4."""
    want_z, want_i = np.asarray(want_z), np.asarray(want_i)
    got_z, got_i = got_z.numpy(), got_i.numpy()
    np.testing.assert_array_equal(got_i >= 0, want_i >= 0)
    differ = got_i != want_i
    assert differ.mean() <= 0.001
    np.testing.assert_allclose(got_z, want_z, rtol=0, atol=1e-4)
    # every differing winner ties the other side's in z
    assert (np.abs(got_z - want_z)[differ] <= 1e-6).all()
    return float((want_i >= 0).mean())


@pytest.mark.parametrize("kind", ["frame", "zlow", "band"])
def test_raster_stage_matches_jax(case, kind):
    js, ts = case["jsetup"], case["tsetup"]
    kw = {}
    if kind == "band":
        kw = dict(origin=(0, 16), band=(W, 32))
    if kind == "zlow":
        # each side peels behind its own first layer (a zlow is only
        # meaningful against the z that raster computed); -inf on 8 rows
        z0, i0 = jd.raster_stage(js, W, H, CHUNK)
        zl = jnp.where(i0 >= 0, z0 + jd.PEEL_EPS, jnp.inf).at[:8].set(
            -jnp.inf)
        want = jd.raster_stage(js, W, H, CHUNK, zlow=zl)
        z0, i0 = td.raster_stage(ts, W, H, CHUNK)
        zl = torch.where(i0 >= 0, z0 + td.PEEL_EPS, float("inf"))
        zl[:8] = -float("inf")
        got = td.raster_stage(ts, W, H, CHUNK, zlow=zl)
    else:
        want = jd.raster_stage(js, W, H, CHUNK, **kw)
        got = td.raster_stage(ts, W, H, CHUNK, **kw)
    assert tuple(got[0].shape) == np.asarray(want[0]).shape
    cover = _hold_winners(*got, *want)
    assert cover > 0.02


def test_raster_multilayer_matches_jax(case):
    want = jd.raster_multilayer(case["jsetup"], W, H, CHUNK, 3,
                                origin=(0, 8), band=(W, 48))
    got = td.raster_multilayer(case["tsetup"], W, H, CHUNK, 3,
                               origin=(0, 8), band=(W, 48))
    assert tuple(got[1].shape) == (3, 48, W)
    for k in range(3):
        _hold_winners(got[0][k], got[1][k], want[0][k], want[1][k])
    # a deep view: the second layer covers pixels
    assert float((got[1][1] >= 0).float().mean()) > 0.05


@pytest.mark.parametrize("pool,mipmap,lit", [
    ("quad", False, False), ("quad", True, True), ("tri", True, False),
    ("bc1", False, False), ("bc1", True, True), ("bc7", False, True),
    ("bc7", True, False)])
def test_shade_src_matches_jax(case, pool, mipmap, lit):
    ts, js = scenes(case, pool)
    _, ib = jd.raster_stage(case["jsetup"], W, H, CHUNK)
    want, wcov = jd.shade_src(js, case["jsetup"], ib, W, H, mipmap=mipmap,
                              lighting=lit)
    got, gcov = td.shade_src(ts, case["tsetup"],
                             torch.from_numpy(np.array(ib)), W, H,
                             mipmap=mipmap, lighting=lit)
    wcov = np.asarray(wcov)
    np.testing.assert_array_equal(gcov.numpy(), wcov)
    d = np.abs(got.numpy() - np.asarray(want))[wcov].max(-1)
    assert (d > 1).mean() <= GOLDEN_SHARE
    assert (d <= 1e-2).mean() >= 0.99


@pytest.mark.parametrize("pool", ["quad", "narrow", "tri", "bc1", "bc7"])
def test_samplers_match_jax(case, pool):
    ts, js = scenes(case, pool)
    rng = np.random.default_rng(11)
    n = 4096
    layer = rng.integers(-1, ts.mip_table.shape[0] + 1, n).astype(np.int32)
    u, v = (rng.uniform(-0.5, 1.5, n).astype(np.float32) for _ in range(2))
    lod = rng.uniform(-1.0, ts.num_mips + 1.0, n).astype(np.float32)
    t = [torch.from_numpy(x) for x in (layer, u, v, lod)]
    j = [jnp.asarray(x) for x in (layer, u, v, lod)]
    for got, want in (
            (td.sample_bilinear(ts, *t[:3]), jd.sample_bilinear(js, *j[:3])),
            (td.sample_trilinear(ts, *t), jd.sample_trilinear(js, *j))):
        got = torch.stack(got, -1).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-3)
        assert got.std() > 1.0


@pytest.mark.parametrize("what", ["single", "peeled", "mipmap", "lit",
                                  "bc1", "bc7"])
def test_scan_frame_matches_jax(case, what):
    pool = what if what in ("bc1", "bc7") else "quad"
    ts, js = scenes(case, pool)
    kw = dict(width=W, height=H, mipmap=what == "mipmap",
              lighting=what == "lit")
    args = (case["vp"], case["bones"])
    jargs = tuple(jnp.asarray(x) for x in args)
    if what == "peeled":
        want = jd.render_frame_peeled(js, *jargs, layers=3, backend="scan",
                                      **kw)
        got = td.render_frame_peeled(ts, *args, layers=3, backend="scan",
                                     **kw)
    else:
        want = jd.render_frame(js, *jargs, backend="scan", **kw)
        got = td.render_frame(ts, *args, backend="scan", **kw)
    want_c, want_d = (np.asarray(x) for x in want)
    got_c, got_d = got
    assert got_c.dtype == torch.uint8 and tuple(got_c.shape) == (H, W, 4)
    np.testing.assert_array_equal(got_d.numpy() < 1.0, want_d < 1.0)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=0, atol=1e-4)
    assert golden_share(got_c.numpy(), want_c) <= GOLDEN_SHARE
    assert 0.05 < (want_d < 1.0).mean()


@pytest.mark.parametrize("n,mipmap,lit", [(1, False, False),
                                          (3, True, True), (8, False, True)])
def test_scan_band_split_equals_the_frame(case, n, mipmap, lit):
    kw = dict(width=W, height=H, backend="scan", mipmap=mipmap,
              lighting=lit)
    args = (case["ts"], case["vp"], case["bones"])
    want = td.render_frame(*args, **kw)
    got = tiles.render_frame_multichip(
        *args, mesh=tiles.make_row_mesh(n, device="cpu"), **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,mipmap,lit", [(2, False, False), (4, True, True)])
def test_scan_geometry_split_equals_the_frame(case, n, mipmap, lit):
    """Shard r rasters triangles [r Tp/n, (r + 1) Tp/n); the MIN/MAX merge
    restores the later-triangle tie rule across shards."""
    kw = dict(width=W, height=H, backend="scan", mipmap=mipmap,
              lighting=lit)
    args = (case["ts"], case["vp"], case["bones"])
    want = td.render_frame(*args, **kw)
    got = tiles.render_frame_geomsplit(
        *args, mesh=tiles.make_row_mesh(n, device="cpu"), **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_scan_split_checks(case):
    args = (case["ts"], case["vp"], case["bones"])
    kw = dict(width=W, height=H, backend="scan",
              mesh=tiles.make_row_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="packed output"):
        tiles.render_frame_multichip(*args, packed=True, **kw)
    with pytest.raises(ValueError, match="split peel requires"):
        tiles.render_frame_multichip(*args, peel_layers=2, **kw)
    with pytest.raises(ValueError, match="whole 16-triangle chunks"):
        tiles.render_frame_geomsplit(
            *args, **dict(kw, mesh=tiles.make_row_mesh(5, device="cpu")))


def test_frame_engine_scan(case):
    ts, vp, bones = case["ts"], case["vp"], case["bones"]
    for peel in (0, 2):
        eng = te.FrameEngine(ts, case["batch"], width=W, height=H,
                             backend="scan", peel=peel, peel_mode="ml")
        assert not eng.packed
        got = eng.render(vp, bones)
        assert eng.maxc is None and eng.tap_tiles is None
        if peel:
            want = td.render_frame_peeled(ts, vp, bones, width=W, height=H,
                                          layers=peel, backend="scan")
        else:
            want = td.render_frame(ts, vp, bones, width=W, height=H,
                                   backend="scan")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        eng.check(vp, bones)


def test_scan_renders_bc_pools_without_mipmap_where_pallas_refuses(case):
    """The bc pool rule: a non-mip frame of a bc1 or bc7 pool renders
    through scan; the binned raster refuses it with the reference's
    words."""
    for pool in ("bc1", "bc7"):
        ts, _ = scenes(case, pool)
        c, _ = td.render_frame(ts, case["vp"], case["bones"], width=W,
                               height=H, backend="scan")
        assert c.dtype == torch.uint8
        with pytest.raises(ValueError, match="or the scan backend"):
            td.render_frame(ts, case["vp"], case["bones"], width=W,
                            height=H)


def test_render_frame_default_backend_diverges_from_jax():
    """A recorded divergence: the port's ``render_frame`` defaults to the
    binned raster ("pallas"), where the reference's defaults to "scan";
    every caller of the port relies on that default, and scan costs
    O(triangles x pixels). The peeled frame's default diverges the same
    way."""
    for fn in ("render_frame", "render_frame_peeled"):
        port = inspect.signature(getattr(td, fn)).parameters["backend"]
        ref = inspect.signature(getattr(jd, fn)).parameters["backend"]
        assert port.default == "pallas" and ref.default == "scan"
    with pytest.raises(ValueError, match="packed output requires"):
        td.render_frame(td.upload(demo.build_demo_batch(), device="cpu"),
                        np.eye(4, dtype=np.float32), None, width=32,
                        height=32, backend="scan", packed=True)
