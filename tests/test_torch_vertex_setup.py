"""Port vs reference: vertex stage (palette skinning + MVP) and the packed
per-triangle setup.

Tolerances: clip coordinates rtol 1e-5 — the port sums the palette and
the MVP rows elementwise where JAX runs fp32 matmuls, so sums round in
another order. Setup gets the SAME clip coordinates on both sides and
runs the same elementwise ops: the valid/REJECT pattern and the valid
groups' bboxes must be exact, the columns within rtol 1e-5 / atol 1e-4
(screen units)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.render import pallas_raster as pr
from mt_renderer_tpu.scene import demo
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr
from torch_threads import one_thread  # noqa: F401

W, H = 256, 128


@pytest.fixture(scope="module")
def scenes():
    batch = demo.build_demo_batch(instances=9, skinned=True, subdiv=1)
    cam = demo.demo_camera(9, W, H)
    return batch, np.asarray(cam.view_proj()), jd.upload(batch), \
        td.upload(batch, device="cpu")


def _palette(seed: int, n: int = 2) -> np.ndarray:
    """Seeded random affine bone palette near the identity."""
    rng = np.random.default_rng(seed)
    m = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    m[:, :3, :] += rng.normal(0, 0.2, (n, 3, 4)).astype(np.float32)
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vertex_stage_matches_jax(scenes, seed):
    _, vp, js, ts = scenes
    bones = _palette(seed)
    want = np.asarray(jd.vertex_stage(js, jnp.asarray(vp),
                                      jnp.asarray(bones)))
    got = td.vertex_stage(ts, vp, bones).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_vertex_stage_unskinned_matches_jax():
    batch = demo.build_demo_batch(instances=4, skinned=False)
    vp = np.asarray(demo.demo_camera(4, W, H).view_proj())
    want = np.asarray(jd.vertex_stage(jd.upload(batch), jnp.asarray(vp),
                                      None))
    got = td.vertex_stage(td.upload(batch, device="cpu"), vp, None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_setup_packed_cols_matches_jax(scenes, seed):
    _, vp, js, ts = scenes
    clip = jd.vertex_stage(js, jnp.asarray(vp), jnp.asarray(_palette(seed)))
    jcols, jbbox, n_attr = jd.setup_packed_cols(js, clip, W, H)
    assert n_attr == pr.ATTRS_BASE
    jcols = np.asarray(jcols).T                            # (33, Tp)
    cols, bbox = td.setup_packed_cols(
        ts, torch.from_numpy(np.asarray(clip)), W, H)
    cols = cols.numpy()
    assert cols.shape == jcols.shape == (
        tr.N_RAST + tr.N_COEF, ts.tri_valid.shape[0])

    rej = jcols[9:12] == pr.REJECT
    np.testing.assert_array_equal(cols[9:12] == tr.REJECT, rej)
    assert 0 < rej[0].sum() < rej.shape[1]      # both kinds present
    np.testing.assert_allclose(cols, jcols, rtol=1e-5, atol=1e-4)

    for g, w in zip(bbox, jbbox):
        g, w = g.numpy(), np.asarray(w)
        live = np.abs(w) < 1e30
        np.testing.assert_array_equal(np.abs(g) < 1e30, live)
        np.testing.assert_array_equal(g[live], w[live])


def test_mat_select_is_a_plain_index():
    rng = np.random.default_rng(5)
    mat = rng.uniform(0, 1, (11, 4)).astype(np.float32)
    idx = rng.integers(0, 11, 768).astype(np.int32)
    want = np.asarray(jd._mat_select(jnp.asarray(mat), jnp.asarray(idx)))
    got = td._mat_select(torch.from_numpy(mat), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
