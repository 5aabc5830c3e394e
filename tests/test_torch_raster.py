"""Port vs reference: the K1 tile raster with its tap epilogue.

``raster_fwd_reference`` (the plain PyTorch version, what ``raster_fwd``
runs on a CPU tensor) against JAX ``raster_pallas_fwd(tap=True,
flat=True)`` in interpret mode, on the SAME packed columns (converted
from JAX's (Tp, ncol) to the port's (ncol, Tp)).

Tolerances: winner ids and coverage exact (same f32 edge/z arithmetic,
same tie rule); tap addresses exact on >= 99.7% of pixels; z within
1e-5 and C rgba exact where covered; fx/fy within 2e-3, because XLA's
CPU backend contracts the epilogue's plane sums into FMAs (the test
``test_tap_fraction_differs_only_by_fma_contraction`` shows that this
is the whole difference).

The CUDA kernel is held against this plain version on the card by
``test_torch_gpu.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.render import pallas_raster as pr
from mt_renderer_tpu.scene import demo
from mt_renderer_tpu.scene.model import DrawBatch, merge_batches
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr
from torch_threads import one_thread  # noqa: F401

W, H = 256, 128


def _scene_cols(batch, vp, bones, width, height):
    """JAX setup → (JAX (cols, bbox), port cols (ncol, Tp), port bbox)."""
    js = jd.upload(batch)
    clip = jd.vertex_stage(js, jnp.asarray(vp),
                           None if bones is None else jnp.asarray(bones))
    cols, bbox, _ = jd.setup_packed_cols(js, clip, width, height)
    tcols = torch.from_numpy(np.ascontiguousarray(np.asarray(cols).T))
    tbbox = tuple(torch.tensor(np.asarray(b)) for b in bbox)
    return (cols, bbox), tcols, tbbox


@pytest.fixture(scope="module")
def demo_case():
    batch = demo.build_demo_batch(instances=9, skinned=True, subdiv=1)
    vp = np.asarray(demo.demo_camera(9, W, H).view_proj())
    bones = demo.demo_bone_mats(0.5)
    jsetup, tcols, tbbox = _scene_cols(batch, vp, bones, W, H)
    maxc = td.auto_maxc(batch, vp, bones, width=W, height=H)
    want = pr.raster_pallas_fwd(
        jsetup, None, 0, 0, width=W, height=H, maxc=maxc, interpret=True,
        n_attr=pr.ATTRS_BASE, tap=True, w_eps=jd.W_EPS, flat=True)
    want = [np.asarray(x) for x in want]
    pre = tr.prebin(tcols, tbbox, 0, 0, width=W, height=H, maxc=maxc)
    return tcols, pre, want


def test_reference_matches_jax_kernel(demo_case):
    tcols, (lists, glists, counts, n_over), want = demo_case
    zb, ib, tattrs, tapidx = tr.raster_fwd_reference(
        tcols, lists, glists, counts, (0, 0), width=W, height=H,
        w_eps=td.W_EPS)
    wzb, wib, wtattrs, wtapidx, wn_over = want
    assert int(n_over) == int(wn_over) == 0
    n_tiles = (W // tr.TILE_W) * (H // tr.TILE_H)
    assert tuple(ib.shape) == wib.shape == (n_tiles, 1, tr.P)
    assert tuple(tattrs.shape) == wtattrs.shape == (n_tiles, 6, tr.P)
    assert ib.dtype == tapidx.dtype == torch.int32

    np.testing.assert_array_equal(ib.numpy(), wib)
    cov = wib >= 0
    assert 0.05 < cov.mean() < 0.95
    assert (tapidx.numpy() == wtapidx).mean() >= 0.997
    np.testing.assert_allclose(zb.numpy()[cov], wzb[cov], atol=1e-5)
    np.testing.assert_array_equal(zb.numpy()[~cov], 1.0)
    cov2 = cov[:, 0, :]
    # C rgba is the winner's columns copied: exact
    for c in range(2, 6):
        np.testing.assert_array_equal(tattrs.numpy()[:, c][cov2],
                                      wtattrs[:, c][cov2])
    # fx, fy: see test_tap_fraction_differs_only_by_fma_contraction
    for c in range(2):
        np.testing.assert_allclose(tattrs.numpy()[:, c][cov2],
                                   wtattrs[:, c][cov2], atol=2e-3)


def test_tap_fraction_differs_only_by_fma_contraction(demo_case):
    """XLA's CPU backend (the JAX side of these tests) contracts the
    epilogue's plane evaluation ``a*px + b*py + c`` into
    ``fma(a, px, b*py) + c``; the port, like the TPU, rounds every op.
    In fx = frac(u*tw - 0.5) one ulp of the u/w plane value is amplified
    by the cancellation in the plane sum and by the texture width, so the
    two differ by up to ~1e-3 there. Re-evaluating the port's OWN winner
    coefficients with that contraction reproduces JAX's fx and fy to
    1e-6: the selection is exact, only the rounding differs."""
    tcols, (lists, glists, counts, _), want = demo_case
    _, ib, _, _ = tr.raster_fwd(tcols, lists, glists, counts, (0, 0),
                                width=W, height=H, w_eps=td.W_EPS)
    win = ib.numpy()[:, 0, :]
    cov = win >= 0
    a = tcols.numpy()[tr.N_RAST:, np.maximum(win, 0)].astype(np.float64)
    t = np.arange(win.shape[0])[:, None]
    flat = np.arange(tr.P)[None, :]
    n_tx = W // tr.TILE_W
    px = (flat % tr.TILE_W + (t % n_tx) * tr.TILE_W + 0.5).astype(np.float32)
    py = (flat // tr.TILE_W + (t // n_tx) * tr.TILE_H + 0.5
          ).astype(np.float32)
    f32 = np.float32

    def ev_fma(i):
        # a*px is exact in f64; one f32 rounding of the sum = the fma
        s = f32(a[i] * px + f32(a[i + 1] * py).astype(np.float64))
        return s + f32(a[i + 2])

    w1 = ev_fma(6)
    inv = f32(1.0) / np.where(np.abs(w1) < f32(td.W_EPS), f32(td.W_EPS), w1)
    for plane, dim, row in ((0, 17, 0), (3, 16, 1)):
        x = ev_fma(plane) * inv * f32(a[dim]) - f32(0.5)
        x0f = np.floor(x)
        frac = np.where(x0f < 0, f32(0.0), x - x0f)
        np.testing.assert_allclose(frac[cov], want[2][:, row][cov],
                                   atol=1e-6)


def test_uncovered_pixels_keep_zero_coefficient_epilogue(demo_case):
    """The reference runs its epilogue on zero coefficients where no
    triangle won: tapidx 0, fx = fy = 0, C = 0."""
    tcols, (lists, glists, counts, _), _ = demo_case
    _, ib, tattrs, tapidx = tr.raster_fwd(
        tcols, lists, glists, counts, (0, 0), width=W, height=H,
        w_eps=td.W_EPS)
    unc = ib[:, 0, :] < 0
    assert unc.any()
    assert (tapidx[:, 0, :][unc] == 0).all()
    assert (tattrs.permute(1, 0, 2)[:, unc] == 0).all()


def test_capped_lists_match_jax_kernel():
    """A cap that drops chunks: both sides skip the same chunks."""
    batch = demo.build_demo_batch(instances=64, skinned=False)
    vp = np.asarray(demo.demo_camera(64, 128, 64).view_proj())
    jsetup, tcols, tbbox = _scene_cols(batch, vp, None, 128, 64)
    want = pr.raster_pallas_fwd(
        jsetup, None, 0, 0, width=128, height=64, maxc=1, interpret=True,
        n_attr=pr.ATTRS_BASE, tap=True, w_eps=jd.W_EPS, flat=True)
    lists, glists, counts, n_over = tr.prebin(tcols, tbbox, 0, 0,
                                              width=128, height=64, maxc=1)
    assert int(n_over) == int(want[4]) > 0
    _, ib, _, _ = tr.raster_fwd(tcols, lists, glists, counts, (0, 0),
                                width=128, height=64, w_eps=td.W_EPS)
    np.testing.assert_array_equal(ib.numpy(), np.asarray(want[1]))


def _tri_batch(color, extra_near=False, fillers=0):
    """A large screen-facing triangle at z=0.5, an optional small nearer
    decoy, and offscreen index fillers that push the next batch into
    another chunk."""
    pos = [[-0.8, -0.8, 0.5], [0.8, -0.8, 0.5], [0.0, 0.8, 0.5]]
    tris = [[0, 1, 2]]
    flat = [list(color) + [255.0]]
    if extra_near:
        pos += [[0.85, 0.85, 0.1], [0.95, 0.85, 0.1], [0.9, 0.95, 0.1]]
        tris += [[3, 4, 5]]
        flat += [[10.0, 10.0, 10.0, 255.0]]
    if fillers:
        base = len(pos)
        pos += [[30.0, 30.0, 0.9], [30.1, 30.0, 0.9], [30.0, 30.1, 0.9]]
        tris += [[base, base + 1, base + 2]] * fillers
        flat += [[1.0, 1.0, 1.0, 255.0]] * fillers
    n, t = len(pos), len(tris)
    return DrawBatch(
        positions=np.asarray(pos, np.float32),
        uvs=np.zeros((n, 2), np.float32),
        joints=np.zeros((n, 4), np.int32),
        weights=np.zeros((n, 4), np.float32),
        tris=np.asarray(tris, np.int64),
        tri_texture=np.full(t, -1, np.int32),
        tri_parts=np.zeros(t, np.int32),
        tri_debug_id=np.zeros(t, np.int32),
        tri_flat=np.asarray(flat, np.float32),
    )


def test_cross_chunk_coplanar_later_index_wins():
    """Exact-z ties resolve by global triangle id even when nearest-first
    chunk order processes the later-index triangle's chunk first: a red
    triangle in chunk 0, a bit-identical blue duplicate more than CT
    indices later whose chunk also holds a nearer decoy."""
    red = _tri_batch((255.0, 0.0, 0.0), fillers=tr.CT)
    blue = _tri_batch((0.0, 0.0, 255.0), extra_near=True)
    m = merge_batches(red, blue)
    assert len(m.tris) > tr.CT
    scene = td.upload(m, device="cpu")
    vp = np.eye(4, dtype=np.float32)
    color, _ = td.render_frame(scene, vp, None, width=128, height=128)
    center = color[64, 64].numpy()
    assert center[2] > 200 and center[0] < 50, center
    want, _ = jd.render_frame(jd.upload(m), vp, None, width=128,
                              height=128, backend="pallas")
    np.testing.assert_array_equal(color.numpy(), np.asarray(want))


def test_cpu_tensors_never_launch_the_kernel(demo_case):
    tcols, (lists, glists, counts, _), _ = demo_case
    before = tr.raster_fwd.launches
    tr.raster_fwd(tcols, lists, glists, counts, (0, 0), width=W, height=H,
                  w_eps=td.W_EPS)
    assert tr.raster_fwd.launches == before == 0


def test_bad_arguments_raise(demo_case):
    tcols, (lists, glists, counts, _), _ = demo_case
    with pytest.raises(ValueError, match="tile-aligned"):
        tr.raster_fwd(tcols, lists, glists, counts, (0, 0), width=200,
                      height=H, w_eps=td.W_EPS)
    with pytest.raises(ValueError, match="lists must be i32"):
        tr.raster_fwd(tcols, lists.long(), glists, counts, (0, 0),
                      width=W, height=H, w_eps=td.W_EPS)
    with pytest.raises(ValueError, match="not meta"):
        tr.raster_fwd(tcols.to("meta"), lists.to("meta"),
                      glists.to("meta"), counts.to("meta"), (0, 0),
                      width=W, height=H, w_eps=td.W_EPS)
