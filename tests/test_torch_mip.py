"""Port vs reference: the mipmapped, lit single-layer frame.

The tri texel pool, the lit setup (42 rows: the normal planes appended),
K1's mtap and lit epilogues, the trilinear shade and the whole packed
frame, each held against the JAX package (Pallas in interpret mode) on
the same seeded scenes. The demo scene carries no normals, so its
lambert factor is the 0.3 floor everywhere; the lit cases give it unit
normals pointing away from its centroid, so that the factor varies.

Tolerances:
- upload and the lit setup: bit for bit (host NumPy for the pool's quad
  rows, the same elementwise ops for the tri rows and the setup);
- K1's plain twin against JAX's interpret kernel: ids and coverage
  exact, the constant planes (tex, pool offset, extents, unlit C)
  exact; u, v within 1e-4 (texture units), the lambert-scaled C within
  1e-4 relative and the gradient planes within 1e-5 relative, because
  XLA's CPU backend contracts the plane sums into FMAs
  (``test_torch_raster.py`` shows this for the tap fractions);
- the trilinear shade on the same mtap planes: at most 0.3% of pixels
  with a channel off by more than 1 (that FMA contraction, and log2's
  last bit, can move a tap across a texel or mip boundary) and 99%
  within 1e-3 (JAX's einsum sums the four corners in another order);
- the port's dense and compacted shades: bit for bit;
- frames: coverage exact, color under the golden rule (at most 0.3% of
  pixels with a channel off by more than 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.render import pallas_raster as pr
from mt_renderer_tpu.scene import demo
from mt_renderer_tpu.scene.model import DrawBatch
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


def _textures_batch():
    """Flat quads with three textures of odd sizes (8x8, 5x3, 1x1), so
    the quad pool has an odd row count and levels without a parent."""
    rng = np.random.default_rng(11)
    textures = [rng.integers(0, 256, s + (4,), dtype=np.uint8)
                for s in ((8, 8), (5, 3), (1, 1))]
    pos, uvs, tris, tex = [], [], [], []
    for i in range(3):
        b = len(pos)
        x = -0.9 + 0.6 * i
        pos += [[x, -0.5, 0.0], [x + 0.5, -0.5, 0.0], [x, 0.5, 0.0],
                [x + 0.5, 0.5, 0.0]]
        uvs += [[0, 0], [1, 0], [0, 1], [1, 1]]
        tris += [[b, b + 1, b + 2], [b + 2, b + 1, b + 3]]
        tex += [i, i]
    n, t = len(pos), len(tris)
    return DrawBatch(
        positions=np.asarray(pos, np.float32),
        uvs=np.asarray(uvs, np.float32),
        joints=np.zeros((n, 4), np.int32),
        weights=np.zeros((n, 4), np.float32),
        tris=np.asarray(tris, np.int32),
        tri_texture=np.asarray(tex, np.int32),
        tri_parts=np.zeros(t, np.int32),
        tri_debug_id=np.zeros(t, np.int32),
        textures=textures)


TRI_SCENES = {
    "demo": lambda: demo.build_demo_batch(instances=9, skinned=True,
                                          subdiv=1),
    "odd_textures": _textures_batch,
    "untextured": lambda: demo.build_demo_batch(instances=2, skinned=False,
                                                subdiv=0),
}


@pytest.fixture(scope="module")
def lit():
    """The lit demo scene on both sides, its view, bones and caps, and
    JAX's lit column matrix converted to the port's layout."""
    batch = with_normals(demo.build_demo_batch(instances=9, skinned=True,
                                               subdiv=1))
    vp = np.asarray(demo.demo_camera(9, W, H).view_proj())
    bones = demo.demo_bone_mats(0.5)
    js = jd.upload(batch, pool_mode="tri")
    ts = td.upload(batch, "tri", device="cpu")
    clip = jd.vertex_stage(js, jnp.asarray(vp), jnp.asarray(bones))
    jcols, jbbox, n_attr = jd.setup_packed_cols(
        js, clip, W, H, bone_mats=jnp.asarray(bones), lighting=True)
    assert n_attr == pr.ATTRS_LIT
    tcols = torch.from_numpy(np.ascontiguousarray(np.asarray(jcols).T))
    tbbox = tuple(torch.tensor(np.asarray(b)) for b in jbbox)
    maxc = td.auto_maxc(batch, vp, bones, width=W, height=H)
    return dict(batch=batch, vp=vp, bones=bones, js=js, ts=ts, clip=clip,
                jsetup=(jcols, jbbox), tcols=tcols,
                pre=tr.prebin(tcols, tbbox, 0, 0, width=W, height=H,
                              maxc=maxc), maxc=maxc,
                taps=td.auto_tap_tiles(batch, vp, bones, width=W, height=H))


# ------------------------------------------------------------- tri pool


@pytest.mark.parametrize("name", sorted(TRI_SCENES))
def test_tri_pool_upload_matches_jax_leaf_by_leaf(name):
    batch = TRI_SCENES[name]()
    js = jd.upload(batch, pool_mode="tri")
    ts = td.upload(batch, "tri", device="cpu")
    assert ts.pool_mode == js.pool_mode == "tri"
    for f in td.TENSOR_FIELDS:
        got, want = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in td.STATIC_FIELDS:
        assert getattr(ts, f) == getattr(js, f), f


def test_scene_from_numpy_carries_the_tri_pool():
    batch = TRI_SCENES["odd_textures"]()
    js = jd.upload(batch, pool_mode="tri")
    leaves = {f: np.asarray(getattr(js, f)) for f in td.TENSOR_FIELDS}
    statics = {f: getattr(js, f) for f in td.STATIC_FIELDS}
    carried = td.scene_from_numpy(leaves, statics, "cpu")
    own = td.upload(batch, "tri", device="cpu")
    for f in td.TENSOR_FIELDS:
        assert torch.equal(getattr(carried, f), getattr(own, f)), f
    leaves["mip_pool"] = leaves["mip_pool"].reshape(-1, 16)
    with pytest.raises(ValueError, match="rows of 128 B"):
        td.scene_from_numpy(leaves, statics, "cpu")


# ---------------------------------------------------------------- setup


def test_light_direction_matches_jax():
    assert td._light_unit() == jd._light_unit()


def test_world_normals_match_jax(lit):
    got = td.world_normals(lit["ts"], lit["bones"]).numpy()
    want = np.asarray(jd.world_normals(lit["js"], jnp.asarray(lit["bones"])))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(want).max() > 0.5


def test_lit_setup_matches_jax(lit):
    """The 42-row lit matrix from the same clip coordinates."""
    cols, bbox = td.setup_packed_cols(
        lit["ts"], torch.from_numpy(np.array(lit["clip"])), W, H,
        bone_mats=lit["bones"], lighting=True)
    assert tuple(cols.shape) == (tr.N_RAST + tr.N_COEF_LIT,
                                 lit["ts"].tri_valid.shape[0])
    np.testing.assert_array_equal(cols.numpy(), lit["tcols"].numpy())
    assert np.abs(cols.numpy()[33:]).max() > 0
    for g, w in zip(bbox, lit["jsetup"][1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------- K1


@pytest.mark.parametrize("mode,lighting", [("tap", True), ("mtap", False),
                                           ("mtap", True)])
def test_k1_epilogues_match_jax_kernel(lit, mode, lighting):
    light = td._light_unit() if lighting else None
    want = pr.raster_pallas_fwd(
        lit["jsetup"], None, 0, 0, width=W, height=H, maxc=lit["maxc"],
        interpret=True, n_attr=pr.ATTRS_LIT if lighting else pr.ATTRS_BASE,
        tap=mode == "tap", mtap=mode == "mtap", w_eps=jd.W_EPS, light=light,
        flat=True)
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in tr.raster_fwd(
        lit["tcols"], *lit["pre"][:3], (0, 0), width=W, height=H,
        w_eps=td.W_EPS, mode=mode, light=light)]
    np.testing.assert_array_equal(got[1], want[1])              # ids
    cov = want[1][:, 0] >= 0
    assert 0.05 < cov.mean() < 0.95
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)      # z
    a, b = got[2].transpose(1, 0, 2)[:, cov], want[2].transpose(1, 0, 2)[
        :, cov]
    n_planes = tr.ATTRS_TAP if mode == "tap" else tr.ATTRS_MTAP
    assert got[2].shape[1] == want[2].shape[1] == n_planes
    if mode == "tap":
        np.testing.assert_array_equal(got[3], want[3])          # tapidx
        uv, color, exact, grads = [0, 1], [2, 3, 4, 5], [], []
        atol_uv = 2e-3          # fx, fy: see test_torch_raster.py
    else:
        uv, color, exact, grads = [0, 1], [7, 8, 9, 10], [2, 3, 4, 5, 6], \
            list(range(11, 17))
        atol_uv = 1e-4
    np.testing.assert_allclose(a[uv], b[uv], atol=atol_uv)
    for c in exact:
        np.testing.assert_array_equal(a[c], b[c])
    np.testing.assert_array_equal(a[color[3]], b[color[3]])     # alpha unlit
    if lighting:
        np.testing.assert_allclose(a[color[:3]], b[color[:3]], rtol=1e-4)
        assert np.ptp(a[color[0]]) > 0           # the lambert term varies
    else:
        np.testing.assert_array_equal(a[color], b[color])
    for c in grads:
        np.testing.assert_allclose(a[c], b[c], rtol=1e-5, atol=1e-12)


# ----------------------------------------------------------- mip shade


def test_mip_shade_matches_jax_on_the_same_planes(lit):
    """Both trilinear shades on JAX's mtap planes (from its interpret
    kernel), dense."""
    _, ib, mattrs, _ = pr.raster_pallas_fwd(
        lit["jsetup"], None, 0, 0, width=W, height=H, maxc=lit["maxc"],
        interpret=True, n_attr=pr.ATTRS_BASE, mtap=True, w_eps=jd.W_EPS,
        flat=True)
    want, wcov, _ = jd.shade_mip_tap_flat_channels(lit["js"], mattrs, ib)
    got, cov, n_over = td.shade_mip_tap_flat_channels(
        lit["ts"], torch.from_numpy(np.array(mattrs)),
        torch.from_numpy(np.array(ib)))
    assert int(n_over) == 0
    np.testing.assert_array_equal(cov.numpy(), np.asarray(wcov))
    g = np.stack([c.numpy() for c in got], -1)[cov.numpy()]
    w = np.stack([np.asarray(c) for c in want], -1)[cov.numpy()]
    err = np.abs(g - w).max(-1)
    assert float((err > 1.0).mean()) <= GOLDEN_SHARE
    assert float((err <= 1e-3).mean()) > 0.99


@pytest.mark.parametrize("pool", ["tri", "quad"])
def test_mip_shade_dense_equals_compacted(pool):
    """The camera pulled back so that some tile rows hold no textured
    chunk and the shade really compacts."""
    batch = with_normals(demo.build_demo_batch(instances=9, skinned=True,
                                               subdiv=1))
    cam = demo.demo_camera(9, W, H)
    cam.position = cam.position * 1.6
    vp = np.asarray(cam.view_proj())
    bones = demo.demo_bone_mats(0.5)
    ts = td.upload(batch, pool, device="cpu")
    taps = td.auto_tap_tiles(batch, vp, bones, width=W, height=H)
    assert taps < (W // tr.TILE_W) * (H // tr.TILE_H)
    cols, bbox = td.setup_packed_cols(ts, td.vertex_stage(ts, vp, bones),
                                      W, H, bone_mats=bones, lighting=True)
    pre = tr.prebin(cols, bbox, 0, 0, width=W, height=H, maxc=16)
    _, ib, mattrs = tr.raster_fwd(cols, *pre[:3], (0, 0), width=W,
                                  height=H, w_eps=td.W_EPS, mode="mtap",
                                  light=td._light_unit())
    dense, cov_d, _ = td.shade_mip_tap_flat_channels(ts, mattrs, ib)
    comp, cov_c, n_over = td.shade_mip_tap_flat_channels(ts, mattrs, ib,
                                                         tap_tiles=taps)
    assert int(n_over) == 0 and torch.equal(cov_d, cov_c)
    for a, b in zip(dense, comp):
        assert torch.equal(a, b)
    assert float(cov_d.float().mean()) > 0.02


def test_tri_pool_serves_the_bilinear_frame():
    """The bilinear frame reads the quad bytes of the tri rows: equal,
    bit for bit, to the same frame from the quad pool."""
    batch = with_normals(TRI_SCENES["demo"]())
    vp = np.asarray(demo.demo_camera(9, W, H).view_proj())
    bones = demo.demo_bone_mats(0.2)
    out = [td.render_frame(td.upload(batch, pool, device="cpu"), vp, bones,
                           width=W, height=H, packed=True, lighting=True)
           for pool in ("quad", "tri")]
    tr.flush_overflow_checks()
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


# ---------------------------------------------------------------- frame


@pytest.mark.parametrize("pool,mipmap", [("tri", True), ("quad", True),
                                         ("tri", False)],
                         ids=["tri-mip", "quad-mip", "tri-tap"])
def test_lit_frame_matches_jax(lit, pool, mipmap):
    """``render_frame(mipmap=..., lighting=True, packed=True)`` with the
    caps sized by ``auto_maxc`` and ``auto_tap_tiles``, each package from
    its own vertex stage."""
    batch, vp, bones = lit["batch"], lit["vp"], lit["bones"]
    js, ts = ((lit["js"], lit["ts"]) if pool == "tri" else
              (jd.upload(batch), td.upload(batch, device="cpu")))
    kw = dict(width=W, height=H, packed=True, mipmap=mipmap, lighting=True,
              maxc=lit["maxc"], tap_tiles=lit["taps"])
    want, wdepth = jd.render_frame(js, vp, bones, backend="pallas", **kw)
    got, depth = td.render_frame(ts, vp, bones, **kw)
    pr.flush_overflow_checks()
    tr.flush_overflow_checks()
    assert got.dtype == torch.int32 and tuple(got.shape) == (H, W)
    cov = np.asarray(wdepth) < 1.0
    np.testing.assert_array_equal(depth.numpy() < 1.0, cov)
    assert 0.05 < cov.mean() < 0.95
    assert golden_share(td.unpack_rgba(got),
                        jd.unpack_rgba(np.asarray(want))) <= GOLDEN_SHARE
    assert (got.numpy().view(np.uint32) == np.asarray(want)).mean() > 0.98


def test_unlit_mip_frame_matches_jax():
    """The headline's case in small: the demo scene has no normals."""
    batch = demo.build_demo_batch(instances=9, skinned=True, subdiv=1)
    vp = np.asarray(demo.demo_camera(9, W, H).view_proj())
    bones = demo.demo_bone_mats(0.7)
    kw = dict(width=W, height=H, packed=True, mipmap=True, lighting=True)
    want, _ = jd.render_frame(jd.upload(batch, pool_mode="tri"), vp, bones,
                              backend="pallas", **kw)
    got, _ = td.render_frame(td.upload(batch, "tri", device="cpu"), vp,
                             bones, **kw)
    pr.flush_overflow_checks()
    tr.flush_overflow_checks()
    assert golden_share(td.unpack_rgba(got),
                        jd.unpack_rgba(np.asarray(want))) <= GOLDEN_SHARE


def test_frame_engine_renders_the_mip_lit_frame(lit):
    batch, ts = lit["batch"], lit["ts"]
    cam = demo.demo_camera(9, W, H)
    eng = te.FrameEngine(ts, batch, width=W, height=H, mipmap=True,
                         lighting=True, check_every=2)
    before = tr.OVERFLOW_EVENTS
    for t in range(3):
        cam.yaw = 15.0 + 2.0 * t
        vp = np.asarray(cam.view_proj())
        bones = demo.demo_bone_mats(0.3 * t)
        got, _ = eng.render(vp, bones)
        want, _ = td.render_frame(ts, vp, bones, width=W, height=H,
                                  packed=True, mipmap=True, lighting=True,
                                  maxc=eng.maxc, tap_tiles=eng.tap_tiles)
        assert torch.equal(got, want)
    eng.check()
    tr.flush_overflow_checks()
    assert tr.OVERFLOW_EVENTS == before

