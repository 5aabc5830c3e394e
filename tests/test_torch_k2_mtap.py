"""Port vs reference: K2's mtap and lit epilogues.

``raster.raster_fwd_ml_reference(mode="mtap", light=...)`` (what
``raster_fwd_ml`` runs on a CPU tensor) against the JAX package's
``raster_pallas_fwd_ml(mtap=True, light=...)`` in interpret mode, on the
same packed columns of the deep textured quad stack of
``test_torch_gpu.stack_batch`` with unit normals pointing away from its
centroid (so that the lambert factor varies): the ``full`` variant over
every triangle and ``nocull`` over the translucent set behind K1's
opaque z-buffer, L = 2 and 4. The CUDA kernel is held to this plain
version bit for bit on the card (``test_torch_gpu.py``).

Tolerances: per-layer ids and coverage exact; the tex column and the
other constant planes exact; z within 1e-5, u and v within 1e-4
(texture units), the lambert-scaled C within 1e-4 relative and the
gradient planes within 1e-5 relative: XLA's CPU backend contracts the
plane sums into FMAs, as PRs 2 and 3 found for K1 and the tap epilogue
(``test_torch_raster.py``, ``test_torch_mip.py``), and near a normal
that interpolates through zero the lambert factor magnifies that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gpu import stack_batch, stack_view_proj

from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.render import pallas_raster as pr
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr
from torch_threads import one_thread  # noqa: F401

W, H = 256, 128


def with_normals(batch):
    """Unit normals pointing away from the batch's centroid."""
    c = batch.positions - batch.positions.mean(0)
    batch.normals = (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(
        np.float32)
    return batch


def _port_cols(cols, bbox):
    return (torch.from_numpy(np.ascontiguousarray(np.asarray(cols).T)),
            tuple(torch.tensor(np.asarray(b)) for b in bbox))


@pytest.fixture(scope="module")
def stack():
    """The lit quad stack: JAX's lit packed setup (all triangles, and
    both sets of the opacity split) and the same columns in the port's
    (ncol, Tp) layout."""
    batch = with_normals(stack_batch())
    js = jd.upload(batch)
    clip = jd.vertex_stage(js, jnp.asarray(stack_view_proj(W, H)), None)
    cols, bbox, n_attr = jd.setup_packed_cols(js, clip, W, H, lighting=True)
    assert n_attr == pr.ATTRS_LIT
    setups = {"all": (cols, bbox)}
    setups["opaque"], setups["translucent"], _ = jd.setup_packed_cols(
        js, clip, W, H, lighting=True, opacity_split=True)
    return setups, {k: _port_cols(*v) for k, v in setups.items()}


# ------------------------------------------------------------------- K2


@pytest.mark.parametrize("variant,layers,lit", [
    ("full", 2, True), ("full", 4, True), ("nocull", 2, True),
    ("nocull", 4, True), ("full", 4, False)])
def test_ml_mtap_reference_matches_jax_kernel(stack, variant, layers, lit):
    setups, ports = stack
    light = td._light_unit() if lit else None
    kw = dict(width=W, height=H, maxc=4, interpret=True,
              n_attr=pr.ATTRS_LIT if lit else pr.ATTRS_BASE, w_eps=jd.W_EPS,
              flat=True, light=light)
    key, zhi = "all", None
    if variant == "nocull":
        zo, io = pr.raster_pallas_fwd(setups["opaque"], None, 0, 0, tap=True,
                                      **kw)[:2]
        zhi = jnp.where(io >= 0, zo, jnp.inf)
        key = "translucent"
    want = pr.raster_pallas_fwd_ml(setups[key], None, 0, 0, layers=layers,
                                   variant=variant, zhi=zhi, mtap=True, **kw)
    wz, wi, wm, wn_over = (np.asarray(x) for x in want)
    cols, bbox = ports[key]
    lists, glists, counts, n_over = tr.prebin(cols, bbox, 0, 0, width=W,
                                              height=H, maxc=4)
    assert int(n_over) == int(wn_over) == 0
    got = tr.raster_fwd_ml(
        cols, lists, glists, counts, (0, 0), width=W, height=H,
        layers=layers, w_eps=td.W_EPS, opaque_cull=variant == "full",
        zhi=None if zhi is None else torch.from_numpy(np.array(zhi)),
        mode="mtap", light=light)
    assert len(got) == 3
    gz, gi, gm = (x.numpy() for x in got)
    n_tiles = (W // tr.TILE_W) * (H // tr.TILE_H)
    assert gm.shape == wm.shape == (n_tiles, 17 * layers, tr.P)

    cov = wi >= 0
    np.testing.assert_array_equal(gi, wi)
    assert cov[:, -1].any(), "the deepest layer is empty: no depth tested"
    np.testing.assert_allclose(gz[cov], wz[cov], atol=1e-5)
    np.testing.assert_array_equal(gz[~cov], 1.0)
    g4 = gm.reshape(n_tiles, layers, 17, tr.P)
    w4 = wm.reshape(n_tiles, layers, 17, tr.P)
    a, b = g4.transpose(2, 0, 1, 3)[:, cov], w4.transpose(2, 0, 1, 3)[:, cov]
    np.testing.assert_array_equal(g4.transpose(2, 0, 1, 3)[:, ~cov], 0.0)
    np.testing.assert_allclose(a[:2], b[:2], atol=1e-4)          # u, v
    for c in (2, 3, 4, 5, 6, 10):            # tex, off, th, tw, alpha
        np.testing.assert_array_equal(a[c], b[c])
    if lit:
        np.testing.assert_allclose(a[7:10], b[7:10], rtol=1e-4)
        assert np.ptp(a[7]) > 0                  # the lambert term varies
    else:
        np.testing.assert_array_equal(a[7:10], b[7:10])
    np.testing.assert_allclose(a[11:], b[11:], rtol=1e-5, atol=1e-12)


def test_ml_lit_tap_layer0_is_the_lit_single_layer_winner(stack):
    """K2's lit tap epilogue on layer 0 equals K1's lit tap, bit for bit
    (the same epilogue on the same winner)."""
    cols, bbox = stack[1]["all"]
    args = (cols, *tr.prebin(cols, bbox, 0, 0, width=W, height=H,
                             maxc=8)[:3], (0, 0))
    kw = dict(width=W, height=H, w_eps=td.W_EPS, light=td._light_unit())
    zb, ib, tattrs, tapidx = tr.raster_fwd_reference(*args, **kw)
    zl, il, tl, xl = tr.raster_fwd_ml_reference(*args, layers=3,
                                                opaque_cull=True, **kw)
    assert torch.equal(il[:, :1], ib) and torch.equal(zl[:, :1], zb)
    assert torch.equal(tl[:, :6], tattrs) and torch.equal(xl[:, :1], tapidx)
    assert bool((il[:, 1] >= 0).any())


def test_ml_mode_arguments_are_checked(stack):
    cols, bbox = stack[1]["all"]
    args = (cols, *tr.prebin(cols, bbox, 0, 0, width=W, height=H,
                             maxc=4)[:3], (0, 0))
    kw = dict(width=W, height=H, layers=2, w_eps=td.W_EPS, opaque_cull=True)
    with pytest.raises(ValueError, match="unknown mode"):
        tr.raster_fwd_ml(*args, mode="plain", **kw)
    with pytest.raises(ValueError, match="unit 3-vector"):
        tr.raster_fwd_ml(*args, light=(1.0, 0.0), **kw)
    with pytest.raises(ValueError, match="cols must be f32"):
        tr.raster_fwd_ml(cols[:33], *args[1:], light=td._light_unit(), **kw)
