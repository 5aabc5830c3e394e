"""Port vs reference: the peeled (order-independent transparency) frames.

The same seeded scenes go through the JAX package (Pallas in interpret
mode) and through the port on the CPU: the glass demo (every 4th
instance translucent, the camera inside the cube field), the deep
textured quad stack of ``test_torch_gpu.stack_batch``, and the scene
shapes of ``tests/test_peeling.py``: the opaque demo, a textured
translucent stack, a deep stack with an opaque floor and a coplanar
translucent/opaque tie.

Tolerances:
- ``setup_packed_cols(opacity_split=True)``: both sets bit for bit (the
  same clip coordinates go in on both sides and the ops are the same
  elementwise f32 ops): rows 9 (the first edge bias, ``REJECT`` for the
  other set) and the group bboxes exactly, and every other row too;
- K2's plain version against ``raster_pallas_fwd_ml(interpret=True)`` on
  the same packed columns: per-layer coverage and ids exact, C rgba
  exact, tap addresses exact on >= 99.7% of covered pixels, z within
  1e-5 and fx/fy within 2e-3 (XLA's CPU backend contracts the plane
  sums into FMAs; ``test_torch_raster.py`` shows this for fx/fy);
- frames: coverage exact, color under the golden rule (at most 0.3% of
  pixels with a channel off by more than 1);
- the port's split against its own ml on opaque scenes, and measured
  caps against JAX's: bit for bit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gpu import stack_batch, stack_view_proj

from mt_renderer_tpu.app.camera import Camera
from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.render import pallas_raster as pr
from mt_renderer_tpu.scene import demo
from mt_renderer_tpu.scene.model import DrawBatch
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import engine as te
from mt_renderer_tpu_torch.render import raster as tr

W, H = 256, 128
GOLDEN_SHARE = 0.003


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small tensor ops, which
    slow down by an order of magnitude when the parallel test workers'
    threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def golden_share(got_u8, want_u8) -> float:
    """Share of pixels with a channel off by more than 1."""
    diff = np.abs(got_u8.astype(np.int32) - want_u8.astype(np.int32))
    return float((diff.max(-1) > 1).mean())


def _glass_view(scale: float = 0.3, width: int = W, height: int = H):
    cam = demo.demo_camera(12, width, height)
    cam.position = cam.position * scale
    return np.asarray(cam.view_proj())


@pytest.fixture(scope="module")
def glass():
    """The glass demo scene on both sides + the JAX caps at its view."""
    batch = demo.make_translucent(demo.build_demo_batch(
        instances=12, skinned=True, subdiv=1), 12)
    vp, bones = _glass_view(), demo.demo_bone_mats(0.4)
    js, ts = jd.upload(batch), td.upload(batch, device="cpu")
    caps = {mode: jd.measure_live_tap_tiles(
        js, vp, bones, width=W, height=H, layers=3, mode=mode)
        for mode in ("split", "ml")}
    return dict(batch=batch, vp=vp, bones=bones, js=js, ts=ts, caps=caps)


@pytest.fixture(scope="module")
def stack():
    """The deep textured quad stack: JAX packed setup (both sets) and the
    same columns converted to the port's (ncol, Tp) layout."""
    batch = stack_batch()
    js = jd.upload(batch)
    clip = jd.vertex_stage(js, jnp.asarray(stack_view_proj(W, H)), None)
    setups = {"all": jd.setup_packed_cols(js, clip, W, H)[:2]}
    setups["opaque"], setups["translucent"], _ = jd.setup_packed_cols(
        js, clip, W, H, opacity_split=True)
    ports = {k: (torch.from_numpy(np.ascontiguousarray(np.asarray(c).T)),
                 tuple(torch.tensor(np.asarray(b)) for b in bb))
             for k, (c, bb) in setups.items()}
    return setups, ports


def _quad_batch(z_and_rgba):
    """Flat-colored screen-facing quads (``tests/test_peeling.py``)."""
    pos, tris, flats = [], [], []
    for i, (z, rgba) in enumerate(z_and_rgba):
        b = i * 4
        s = 1.5
        pos += [[-s, -s, z], [s, -s, z], [-s, s, z], [s, s, z]]
        tris += [[b + 0, b + 1, b + 2], [b + 2, b + 1, b + 3]]
        flats += [list(rgba)] * 2
    n, t = len(pos), len(tris)
    return DrawBatch(
        positions=np.array(pos, np.float32),
        uvs=np.zeros((n, 2), np.float32),
        joints=np.zeros((n, 4), np.int32),
        weights=np.zeros((n, 4), np.float32),
        tris=np.array(tris, np.int32),
        tri_texture=np.full(t, -1, np.int32),
        tri_parts=np.zeros(t, np.int32),
        tri_debug_id=np.zeros(t, np.int32),
        tri_flat=np.array(flats, np.float32))


def _textured_stack(alpha_front):
    """A textured front quad over an opaque red textured back quad."""
    front = np.full((8, 8, 4), (200, 200, 200, alpha_front), np.uint8)
    back = np.full((8, 8, 4), (255, 0, 0, 255), np.uint8)
    batch = _quad_batch([(0.0, (0, 0, 0, 255)), (-1.0, (0, 0, 0, 255))])
    batch.tri_flat = None
    batch.uvs = np.tile(np.float32([[0, 0], [1, 0], [0, 1], [1, 1]]),
                        (2, 1))
    batch.tri_texture = np.array([0, 0, 1, 1], np.int32)
    batch.textures = [front, back]
    return batch


def _quad_vp():
    return np.asarray(Camera(position=[0, 0, 3]).view_proj())


def _peeled(scene, vp, bones=None, *, width=48, height=48, **kw):
    color, depth = td.render_frame_peeled(scene, vp, bones, width=width,
                                          height=height, **kw)
    tr.flush_overflow_checks()
    return color.numpy(), depth.numpy()


# ------------------------------------------------------------------ (a)


def test_setup_opacity_split_matches_jax(glass):
    js, ts = glass["js"], glass["ts"]
    clip = jd.vertex_stage(js, jnp.asarray(glass["vp"]),
                           jnp.asarray(glass["bones"]))
    jsets = jd.setup_packed_cols(js, clip, W, H, opacity_split=True)[:2]
    tsets = td.setup_packed_cols(ts, torch.from_numpy(np.asarray(clip)),
                                 W, H, opacity_split=True)
    whole, _ = td.setup_packed_cols(ts, torch.from_numpy(np.asarray(clip)),
                                    W, H)
    rejected = []
    for (jc, jb), (tc, tb) in zip(jsets, tsets):
        jc, tc = np.asarray(jc).T, tc.numpy()
        np.testing.assert_array_equal(tc[9], jc[9])
        for g, w in zip(tb, jb):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(tc, jc)
        # the sets differ from the unsplit columns only in row 9
        np.testing.assert_array_equal(np.delete(tc, 9, 0),
                                      np.delete(whole.numpy(), 9, 0))
        rejected.append(tc[9] == tr.REJECT)
    # every valid triangle is live in exactly one set
    valid = whole.numpy()[9] != tr.REJECT
    assert 0 < (valid & ~rejected[0]).sum() < valid.sum()
    np.testing.assert_array_equal(~rejected[0] | ~rejected[1], valid)
    assert not (~rejected[0] & ~rejected[1]).any()


# ------------------------------------------------------------------ (b)


@pytest.mark.parametrize("variant,layers", [("full", 2), ("nocull", 4)])
def test_ml_reference_matches_jax_kernel(stack, variant, layers):
    setups, ports = stack
    kw = dict(width=W, height=H, maxc=4, interpret=True,
              n_attr=pr.ATTRS_BASE, tap=True, w_eps=jd.W_EPS, flat=True)
    key, zhi = "all", None
    if variant == "nocull":
        zo, io, _, _, _ = pr.raster_pallas_fwd(setups["opaque"], None, 0, 0,
                                               **kw)
        zhi = jnp.where(io >= 0, zo, jnp.inf)
        key = "translucent"
    want = pr.raster_pallas_fwd_ml(setups[key], None, 0, 0, layers=layers,
                                   variant=variant, zhi=zhi, **kw)
    wz, wi, wt, wx, wn_over = (np.asarray(x) for x in want)
    cols, bbox = ports[key]
    lists, glists, counts, n_over = tr.prebin(cols, bbox, 0, 0, width=W,
                                              height=H, maxc=4)
    assert int(n_over) == int(wn_over) == 0
    got = tr.raster_fwd_ml_reference(
        cols, lists, glists, counts, (0, 0), width=W, height=H,
        layers=layers, w_eps=td.W_EPS, opaque_cull=variant == "full",
        zhi=None if zhi is None else torch.from_numpy(np.asarray(zhi)))
    gz, gi, gt, gx = (x.numpy() for x in got)
    n_tiles = (W // tr.TILE_W) * (H // tr.TILE_H)
    assert gi.shape == wi.shape == (n_tiles, layers, tr.P)
    assert gt.shape == wt.shape == (n_tiles, 6 * layers, tr.P)

    cov = wi >= 0
    np.testing.assert_array_equal(gi >= 0, cov)
    np.testing.assert_array_equal(gi, wi)
    assert cov[:, -1].any(), "the deepest layer is empty: no depth tested"
    np.testing.assert_allclose(gz[cov], wz[cov], atol=1e-5)
    np.testing.assert_array_equal(gz[~cov], 1.0)
    assert (gx[cov] == wx[cov]).mean() >= 0.997
    g4 = gt.reshape(n_tiles, layers, 6, tr.P)
    w4 = wt.reshape(n_tiles, layers, 6, tr.P)
    for c in range(2, 6):
        np.testing.assert_array_equal(g4[:, :, c][cov], w4[:, :, c][cov])
    for c in range(2):
        np.testing.assert_allclose(g4[:, :, c][cov], w4[:, :, c][cov],
                                   atol=2e-3)


def _kernel_model(cols, lists, glists, counts, *, width, layers,
                  opaque_cull, zhi, order):
    """The CUDA kernel's loop (``csrc/raster_fwd_ml.cu``) in torch,
    vectorized over pixels: every candidate that passes the culls is
    inserted on its own, in the arrival ``order`` (a permutation of a
    chunk's triangles), into the L-deep (z asc, id desc) list. Returns
    (zl, il) as the kernel writes them."""
    n_tiles = counts.shape[0]
    px, py = tr._pixel_centers(width, n_tiles // (width // tr.TILE_W)
                               * tr.TILE_H, (0, 0), cols.device)
    inf = float("inf")
    zl = torch.full((n_tiles, layers, tr.P), inf)
    il = torch.full((n_tiles, layers, tr.P), -1, dtype=torch.int32)
    zop = torch.full((n_tiles, tr.P), inf)
    zh = zhi[:, 0] if zhi is not None else torch.full_like(zop, inf)
    for t in range(n_tiles):
        for s in range(int(counts[t])):
            cid, gmask = int(lists[t, s]), int(glists[t, s])
            for k in order:
                if not (gmask >> (k // tr.KG)) & 1:
                    continue
                c = cols[:, cid * tr.CT + k]
                e = [c[i] * px[t] + c[3 + i] * py[t] + c[6 + i] > c[9 + i]
                     for i in range(3)]
                z = c[12] * px[t] + c[13] * py[t] + c[14]
                zlim = torch.minimum(torch.minimum(zl[t, -1], zh[t]), zop[t])
                ok = e[0] & e[1] & e[2] & (z >= 0) & (z < inf) & (z <= zlim)
                if opaque_cull and float(c[tr.TEX_ROW]).is_integer():
                    zop[t] = torch.where(ok, z, zop[t])
                zc = torch.where(ok, z, inf)
                ic = torch.where(ok, cid * tr.CT + k, -1).to(torch.int32)
                for layer in range(layers):
                    ze, ie = zl[t, layer].clone(), il[t, layer].clone()
                    swap = (zc < ze) | ((zc == ze) & (ic > ie))
                    zl[t, layer] = torch.where(swap, zc, ze)
                    il[t, layer] = torch.where(swap, ic, ie)
                    zc, ic = torch.where(swap, ze, zc), torch.where(swap, ie,
                                                                     ic)
    if opaque_cull:
        il = torch.where(zl > zop[:, None], -1, il)
    return torch.where(il >= 0, zl, 1.0), il


@pytest.mark.parametrize("opaque_cull", [True, False])
def test_per_candidate_insertion_equals_per_group_extraction(stack,
                                                             opaque_cull):
    """The kernel's per-candidate insertion, in three arrival orders,
    gives the plain version's (the reference's per-group form) lists
    exactly: the order-independence argument of the kernel's header."""
    cols, bbox = stack[1]["all"]
    lists, glists, counts, _ = tr.prebin(cols, bbox, 0, 0, width=W,
                                         height=H, maxc=4)
    kw = dict(width=W, layers=4, opaque_cull=opaque_cull, zhi=None)
    zl, il, _, _ = tr.raster_fwd_ml_reference(
        cols, lists, glists, counts, (0, 0), height=H, w_eps=td.W_EPS, **kw)
    assert bool((il[:, 3] >= 0).any())
    rng = np.random.default_rng(3)
    for order in (range(tr.CT), range(tr.CT - 1, -1, -1),
                  rng.permutation(tr.CT)):
        mz, mi = _kernel_model(cols, lists, glists, counts, order=order,
                               **kw)
        assert torch.equal(mi, il) and torch.equal(mz, zl)


def test_ml_bad_arguments_raise(stack):
    cols, bbox = stack[1]["all"]
    lists, glists, counts, _ = tr.prebin(cols, bbox, 0, 0, width=W,
                                         height=H, maxc=4)
    args = (cols, lists, glists, counts, (0, 0))
    kw = dict(width=W, height=H, w_eps=td.W_EPS, opaque_cull=True)
    for layers in (1, 9):
        with pytest.raises(ValueError, match="out of range"):
            tr.raster_fwd_ml(*args, layers=layers, **kw)
    with pytest.raises(ValueError, match="zhi must be f32"):
        tr.raster_fwd_ml(*args, layers=2, zhi=torch.zeros(counts.shape[0],
                                                          tr.P), **kw)
    with pytest.raises(ValueError, match="not meta"):
        tr.raster_fwd_ml(*(a.to("meta") if torch.is_tensor(a) else a
                           for a in args), layers=2, **kw)
    before = tr.raster_fwd_ml.launches
    tr.raster_fwd_ml(*args, layers=2, **kw)
    assert tr.raster_fwd_ml.launches == before == 0


# ------------------------------------------------------------------ (c)


@pytest.mark.parametrize("scene", ["stack", "glass"])
def test_ml_layer0_is_the_single_layer_winner(stack, glass, scene):
    if scene == "stack":
        cols, bbox = stack[1]["all"]
    else:
        ts = glass["ts"]
        cols, bbox = td.setup_packed_cols(
            ts, td.vertex_stage(ts, glass["vp"], glass["bones"]), W, H)
    args = (cols, *tr.prebin(cols, bbox, 0, 0, width=W, height=H,
                             maxc=8)[:3], (0, 0))
    zb, ib, tattrs, tapidx = tr.raster_fwd_reference(
        *args, width=W, height=H, w_eps=td.W_EPS)
    zl, il, tl, xl = tr.raster_fwd_ml_reference(
        *args, width=W, height=H, layers=3, w_eps=td.W_EPS,
        opaque_cull=True)
    assert torch.equal(il[:, :1], ib) and torch.equal(zl[:, :1], zb)
    assert torch.equal(tl[:, :6], tattrs) and torch.equal(xl[:, :1], tapidx)
    assert bool((ib >= 0).any()) and bool((il[:, 1] >= 0).any())


# ------------------------------------------------------------------ (d)


@pytest.mark.parametrize("mode", ["split", "ml"])
def test_packed_peeled_frame_matches_jax(glass, mode):
    """Dense and with the measured caps, against JAX's frame with the
    same caps (JAX's own tests hold its compacted frame equal to its
    dense one)."""
    caps = glass["caps"][mode]
    want, wdepth = jd.render_frame_peeled(
        glass["js"], glass["vp"], glass["bones"], width=W, height=H,
        layers=3, backend="pallas", peel_mode=mode, packed=True,
        tap_tiles=caps)
    pr.flush_overflow_checks()
    want, wdepth = jd.unpack_rgba(np.asarray(want)), np.asarray(wdepth)
    cov = wdepth < 1.0
    assert 0.2 < cov.mean() < 1.0
    frames = {}
    for taps in (None, caps):
        got, depth = td.render_frame_peeled(
            glass["ts"], glass["vp"], glass["bones"], width=W, height=H,
            layers=3, peel_mode=mode, packed=True, tap_tiles=taps)
        tr.flush_overflow_checks()
        assert got.dtype == torch.int32 and tuple(got.shape) == (H, W)
        np.testing.assert_array_equal(depth.numpy() < 1.0, cov)
        assert golden_share(td.unpack_rgba(got), want) <= GOLDEN_SHARE
        frames[taps is None] = got
    # the caps compact some taps, and compaction changes no pixel
    n = (W // tr.TILE_W) * (H // tr.TILE_H)
    assert sum(caps) < 4 * n if mode == "split" else caps < 3 * n
    assert torch.equal(frames[True], frames[False])


def test_unpacked_peeled_frame_is_a_view_of_packed(glass):
    kw = dict(width=W, height=H, layers=3, peel_mode="split",
              tap_tiles=glass["caps"]["split"])
    packed, _ = _peeled(glass["ts"], glass["vp"], glass["bones"],
                        packed=True, **kw)
    rgba, _ = _peeled(glass["ts"], glass["vp"], glass["bones"], **kw)
    assert rgba.dtype == np.uint8 and rgba.shape == (H, W, 4)
    np.testing.assert_array_equal(rgba, td.unpack_rgba(packed))


# ------------------------------------------------------------------ (e)


@pytest.mark.parametrize("scene", ["demo", "textured_opaque", "glass_opaque"])
def test_split_equals_ml_on_opaque_scenes(glass, scene):
    """Bit for bit, color and depth: split packed with its measured caps
    against ml unpacked and dense, as the reference's ``peel_split``
    verify leg holds them."""
    bones = None
    if scene == "demo":
        batch = demo.build_demo_batch(instances=4, skinned=True, subdiv=1)
        vp, bones = (np.asarray(demo.demo_camera(4, 96, 96).view_proj()),
                     demo.demo_bone_mats(0.4))
        w = h = 96
    elif scene == "textured_opaque":
        batch, vp, w, h = _textured_stack(255), _quad_vp(), 64, 64
    else:
        batch = demo.build_demo_batch(instances=12, skinned=True, subdiv=1)
        vp, bones, w, h = _glass_view(), glass["bones"], W, H
    ts = td.upload(batch, device="cpu")
    kw = dict(width=w, height=h, layers=3)
    caps = td.measure_live_tap_tiles(ts, vp, bones, mode="split", **kw)
    sp, sd = _peeled(ts, vp, bones, peel_mode="split", packed=True,
                     tap_tiles=caps, **kw)
    ml, md = _peeled(ts, vp, bones, peel_mode="ml", **kw)
    np.testing.assert_array_equal(td.unpack_rgba(sp), ml)
    np.testing.assert_array_equal(sd, md)
    assert (md < 1.0).any()
    # and ml's nearest layer reproduces the single-layer frame
    single, _ = td.render_frame(ts, vp, bones, width=w, height=h)
    np.testing.assert_array_equal(ml, single.numpy())


def test_deep_stack_keeps_opaque_floor():
    """4 translucent quads over an opaque one: split with L=4 equals ml
    with L=5 (the opaque floor takes no list slot); with L=2 the two
    nearest translucent quads blend over the opaque one."""
    stack = [(0.8, (255, 0, 0, 100)), (0.6, (0, 255, 0, 100)),
             (0.4, (0, 0, 255, 100)), (0.2, (255, 255, 0, 100)),
             (-0.5, (40, 40, 40, 255))]
    ts = td.upload(_quad_batch(stack), device="cpu")
    sp4, _ = _peeled(ts, _quad_vp(), peel_mode="split", layers=4)
    ml5, _ = _peeled(ts, _quad_vp(), peel_mode="ml", layers=5)
    np.testing.assert_array_equal(sp4, ml5)
    sp2, _ = _peeled(ts, _quad_vp(), peel_mode="split", layers=2)
    a = 100 / 255.0
    want = np.array([40, 40, 40], float)
    for rgb in ([0, 255, 0], [255, 0, 0]):       # 2 nearest, back to front
        want = np.array(rgb, float) * a + want * (1 - a)
    np.testing.assert_allclose(sp2[24, 24, :3], np.round(want), atol=1)


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_coplanar_translucent_opaque_tie(order):
    """The later (larger id) of two coplanar quads composites in front:
    a translucent quad drawn after the opaque one shows over it, one
    drawn before hides behind it. Split equals ml."""
    quads = [None, None]
    quads[order[0]] = (0.0, (0, 0, 255, 128))     # translucent
    quads[order[1]] = (0.0, (200, 0, 0, 255))     # opaque
    ts = td.upload(_quad_batch(quads), device="cpu")
    ml, _ = _peeled(ts, _quad_vp(), peel_mode="ml", layers=3)
    sp, _ = _peeled(ts, _quad_vp(), peel_mode="split", layers=3)
    np.testing.assert_array_equal(sp, ml)
    px = sp[24, 24, :3].astype(float)
    if order == (0, 1):                           # translucent first: hidden
        np.testing.assert_array_equal(px, [200, 0, 0])
    else:
        a = 128 / 255.0
        np.testing.assert_allclose(
            px, np.round(np.array([0, 0, 255]) * a
                         + np.array([200, 0, 0]) * (1 - a)), atol=1)


def test_textured_translucent_stack_shows_the_back(glass):
    """A textured alpha-128 quad over an opaque red one: the red bleeds
    through, in both modes, equally."""
    ts = td.upload(_textured_stack(128), device="cpu")
    sp, _ = _peeled(ts, _quad_vp(), width=64, height=64, layers=3,
                    peel_mode="split")
    ml, _ = _peeled(ts, _quad_vp(), width=64, height=64, layers=3,
                    peel_mode="ml")
    np.testing.assert_array_equal(sp, ml)
    c = sp[32, 32].astype(int)
    assert c[0] > c[1] + 40


# ------------------------------------------------------------------ (f)


@pytest.mark.parametrize("mode", ["split", "ml"])
def test_measure_live_tap_tiles_matches_jax(glass, mode):
    got = td.measure_live_tap_tiles(glass["ts"], glass["vp"],
                                    glass["bones"], width=W, height=H,
                                    layers=3, mode=mode)
    assert got == glass["caps"][mode]
    assert isinstance(got, tuple) == (mode == "split")


# ------------------------------------------------------------------ (g)


def test_split_tap_overflow_is_loud_not_silent(monkeypatch):
    """A cap pair of (8, 8) under a frame whose 16 opaque rows are all
    live and textured."""
    ts = td.upload(_textured_stack(128), device="cpu")
    tr.flush_overflow_checks()
    before = tr.OVERFLOW_EVENTS
    # the event count is the process's: restore it afterwards
    monkeypatch.setattr(tr, "OVERFLOW_EVENTS", before)
    with pytest.warns(RuntimeWarning, match="tap overflow"):
        td.render_frame_peeled(ts, _quad_vp(), None, width=W, height=H,
                               layers=2, peel_mode="split",
                               tap_tiles=(8, 8))
        tr.flush_overflow_checks()
    assert tr.OVERFLOW_EVENTS == before + 1


def test_peel_arguments_are_checked(glass):
    ts, vp = glass["ts"], glass["vp"]
    kw = dict(width=W, height=H)
    with pytest.raises(ValueError, match="cap pair"):
        td.render_frame_peeled(ts, vp, None, peel_mode="ml",
                               tap_tiles=(8, 8), **kw)
    with pytest.raises(ValueError, match="layers >= 2"):
        td.render_frame_peeled(ts, vp, None, peel_mode="split", layers=1,
                               **kw)
    for layers in (1, 9):
        with pytest.raises(ValueError, match="out of range"):
            td.render_frame_peeled(ts, vp, None, layers=layers, **kw)
    with pytest.raises(ValueError, match="unknown peel_mode"):
        td.render_frame_peeled(ts, vp, None, peel_mode="zsort", **kw)


@pytest.mark.parametrize("kw,what", [
    (dict(peel_mode="multipass"), "packed peeled output"),
    (dict(backend="scan"), "packed peeled output"),
])
def test_unported_peel_options_raise(glass, kw, what):
    """The multipass peel and the scan backend's peel, once refused,
    render the glass scene: the (H, W, 4) uint8 frame, its coverage equal
    to the ml peel's; a packed frame, which the reference refuses for
    them, still raises."""
    args = (glass["ts"], glass["vp"], None)
    got, got_d = td.render_frame_peeled(*args, width=W, height=H, **kw)
    _, want_d = td.render_frame_peeled(*args, width=W, height=H)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (H, W, 4)
    assert torch.equal(got_d < 1.0, want_d < 1.0)
    with pytest.raises(ValueError, match=what):
        td.render_frame_peeled(*args, width=W, height=H, packed=True, **kw)


def test_unported_split_and_measure_options_raise(glass):
    """Band sizing exists for the split peel only, as in the reference
    (``tests/test_multichip.py::test_bands_requires_split_mode``)."""
    ts, vp = glass["ts"], glass["vp"]
    with pytest.raises(ValueError, match="bands"):
        td.measure_live_tap_tiles(ts, vp, None, width=W, height=H,
                                  layers=2, mode="ml", bands=2)
    with pytest.raises(ValueError, match="bands"):
        jd.measure_live_tap_tiles(glass["js"], vp, None, width=W, height=H,
                                  layers=2, mode="ml", bands=2)


# ------------------------------------------------------------------ (h)


def test_peeled_engine_sizes_guards_and_recovers(glass):
    """A camera flying into the glass field, each step held to the
    reference engine's rules: the engine sizes the cap pair at the first
    view as ``measure_live_tap_tiles`` measures it (held to JAX's by
    ``test_measure_live_tap_tiles_matches_jax``); before a view whose
    single-layer row bound (``guard_counts``' second count, with the
    engine's headroom, rounded up to 8 and clamped to the grid's rows)
    grew it measures again and grows the pair element by element; it renders the frame ``render_frame_peeled``
    renders with its caps; and when a frame overflowed a cap anyway (the
    peeled caps have no host bound), the next check grows each cap to at
    least twice its size and the fresh need, clamped to (rows,
    rows x L). The fly-in below takes both growth paths."""
    batch, ts, bones = glass["batch"], glass["ts"], glass["bones"]
    eng = te.FrameEngine(ts, batch, width=W, height=H, peel=3,
                         peel_mode="split", check_every=10**6)
    nrows = (W // tr.TILE_W) * (H // tr.TILE_H)
    before = tr.OVERFLOW_EVENTS
    grew_by = []
    for scale in (2.0, 1.5, 1.0, 0.3):
        vp = _glass_view(scale)
        live = int(td.guard_counts(ts, vp, bones, width=W, height=H)[1])
        bound = min(max(8, -(-math.ceil(live * eng.headroom) // 8) * 8),
                    nrows)
        old, old_bound = eng.tap_tiles, eng._tap_bound
        got, _ = eng.render(vp, bones)
        fresh = td.measure_live_tap_tiles(
            ts, vp, bones, width=W, height=H, layers=3, maxc=eng.maxc,
            mode="split", margin=eng.headroom)
        if old is None:
            assert eng.tap_tiles == fresh
        elif bound > old_bound:
            assert eng.tap_tiles == tuple(max(o, f)
                                          for o, f in zip(old, fresh))
        else:
            assert eng.tap_tiles == old
        if old is not None and eng.tap_tiles != old:
            grew_by.append("guard")
        want, _ = td.render_frame_peeled(
            ts, vp, bones, width=W, height=H, layers=3, maxc=eng.maxc,
            peel_mode="split", packed=True, tap_tiles=eng.tap_tiles,
            check_overflow=False)
        assert torch.equal(got, want)
        caps = eng.tap_tiles
        counts = eng.check(vp, bones)
        n_tap = sum(n for what, (n, _) in counts.items()
                    if what.startswith("tap"))
        if n_tap:
            grew_by.append("check")
            assert eng.tap_tiles == tuple(
                min(max(f, 2 * c), hi)
                for c, f, hi in zip(caps, fresh, (nrows, 3 * nrows)))
        else:
            assert eng.tap_tiles == caps
    tr.flush_overflow_checks()
    assert tr.OVERFLOW_EVENTS == before
    assert grew_by == ["guard", "check"]


def test_frame_profile_runs_the_split_peel(capsys):
    """``frame_profile --translucent --peel L`` rehearses on CPU
    tensors: every stage of the split frame prints, and the profiler says
    plainly that it saw no device."""
    from mt_renderer_tpu_torch import frame_profile

    assert frame_profile.main(
        ["--device", "cpu", "--instances", "12", "--subdiv", "1",
         "--width", "256", "--height", "128", "--views", "1",
         "--frames", "1", "--prof-frames", "1", "--translucent",
         "--peel", "3"]) == 0
    out = capsys.readouterr().out
    for head in ("translucent=True, peel=3", "render_frame_peeled, caps",
                 "raster_fwd (K1), opaque set", "raster_fwd_ml (K2), "
                 "translucent set", "composite_peeled_tap_flat",
                 "opaque tap shade + blend", "binning, translucent set:"):
        assert head in out
    assert "idle share not measured" in out
