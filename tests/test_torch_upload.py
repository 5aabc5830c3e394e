"""Port vs reference: scene upload (quad texel pool) and carrying a JAX
scene's state across with ``scene_from_numpy``.

Tolerance: none. Upload is host NumPy on both sides, so every leaf must
be bit-identical."""

import numpy as np
import pytest
import torch

from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.scene import demo
from mt_renderer_tpu.scene.model import DrawBatch
from mt_renderer_tpu_torch.render import device as td


def _flat_batch():
    """Untextured flat-color triangles with a few materials and parts."""
    rng = np.random.default_rng(7)
    nt = 50
    return DrawBatch(
        positions=rng.uniform(-1, 1, (3 * nt, 3)).astype(np.float32),
        uvs=rng.uniform(0, 1, (3 * nt, 2)).astype(np.float32),
        joints=np.zeros((3 * nt, 4), np.int32),
        weights=np.zeros((3 * nt, 4), np.float32),
        tris=np.arange(3 * nt, dtype=np.int64).reshape(nt, 3),
        tri_texture=np.full(nt, -1, np.int32),
        tri_parts=rng.integers(0, 10, nt).astype(np.int32),
        tri_debug_id=rng.integers(0, 40, nt).astype(np.int32),
        tri_flat=rng.uniform(0, 255, (nt, 4)).astype(np.float32),
    )


def _empty_batch():
    batch = demo.build_demo_batch(instances=1, skinned=False)
    batch.tris = batch.tris[:0]
    batch.tri_texture = batch.tri_texture[:0]
    batch.tri_parts = batch.tri_parts[:0]
    batch.tri_debug_id = batch.tri_debug_id[:0]
    return batch


SCENES = {
    "skinned_subdiv1": lambda: demo.build_demo_batch(
        instances=9, skinned=True, subdiv=1),
    "unskinned": lambda: demo.build_demo_batch(instances=4, skinned=False),
    "translucent": lambda: demo.make_translucent(
        demo.build_demo_batch(instances=8, skinned=True), 8),
    "flat_colors": _flat_batch,
    "empty": _empty_batch,
}


def jax_leaves(js):
    """A JAX DeviceScene's leaves and statics as the port reads them."""
    leaves = {f: np.asarray(getattr(js, f)) for f in td.TENSOR_FIELDS}
    statics = {f: getattr(js, f) for f in td.STATIC_FIELDS}
    return leaves, statics


@pytest.mark.parametrize("name", sorted(SCENES))
def test_upload_matches_jax_leaf_by_leaf(name):
    batch = SCENES[name]()
    js = jd.upload(batch, pool_mode="quad")
    ts = td.upload(batch, pool_mode="quad", device="cpu")
    leaves, statics = jax_leaves(js)
    for f in td.TENSOR_FIELDS:
        got = getattr(ts, f).numpy()
        assert got.dtype == leaves[f].dtype, (f, got.dtype, leaves[f].dtype)
        np.testing.assert_array_equal(got, leaves[f], err_msg=f)
    for f in td.STATIC_FIELDS:
        assert getattr(ts, f) == statics[f], f


def test_scene_from_numpy_matches_own_upload():
    batch = SCENES["skinned_subdiv1"]()
    leaves, statics = jax_leaves(jd.upload(batch))
    carried = td.scene_from_numpy(leaves, statics, "cpu")
    own = td.upload(batch, device="cpu")
    for f in td.TENSOR_FIELDS:
        assert torch.equal(getattr(carried, f), getattr(own, f)), f
    for f in td.STATIC_FIELDS:
        assert getattr(carried, f) == getattr(own, f), f
    assert carried.device == torch.device("cpu")


def test_unknown_pool_mode_is_a_value_error():
    batch = demo.build_demo_batch(instances=1, skinned=False)
    with pytest.raises(ValueError, match="unknown pool_mode"):
        td.upload(batch, pool_mode="nope", device="cpu")


def test_mip_chain_matches_reference():
    rng = np.random.default_rng(3)
    for shape in [(64, 64), (16, 4), (1, 8), (5, 1), (7, 3)]:
        img = rng.integers(0, 256, shape + (4,), dtype=np.uint8)
        want = jd.mip_chain(img)
        got = td.mip_chain(img)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
