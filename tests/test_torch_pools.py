"""Port vs reference: the rest of upload (the narrow pool, ``mip_chains``,
``pool_bias``, the budget and ``pool_mode="auto"``), ``pool_stats``,
``set_parts_mask``, ``count_covered_textured`` and the narrow pool's
frames.

Tolerance: none. Upload is host NumPy on both sides, so every leaf must
be bit-identical; the narrow pool's frames equal the quad pool's bit for
bit (the same contraction of the same texels), through the plain K1 and
K2 on CPU tensors.

One divergence is decided and pinned here: the port's budget charges the
stored pool once, where the reference charges it twice for the copy XLA
makes of a gathered-from pool inside its program (reference
``device.py:576-581``). At a budget between the two charges the port
keeps a mode (or a bias) that the reference gives up.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.scene import demo
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr
from test_torch_upload import SCENES, jax_leaves
from torch_threads import one_thread  # noqa: F401

W, H = 128, 64


def assert_scene_equal(ts, js):
    """Every leaf and static of the port's scene against the JAX one's."""
    leaves, statics = jax_leaves(js)
    for f in td.TENSOR_FIELDS:
        got = getattr(ts, f).numpy()
        assert got.dtype == leaves[f].dtype, (f, got.dtype, leaves[f].dtype)
        np.testing.assert_array_equal(got, leaves[f], err_msg=f)
    for f in td.STATIC_FIELDS:
        assert getattr(ts, f) == statics[f], f


def seeded_chains(seed: int = 4):
    """Two textures' mip chains whose levels halve in extent but are not
    box-filter related (odd sizes, partial alpha)."""
    rng = np.random.default_rng(seed)
    chains = []
    for h, w in ((37, 23), (8, 8)):
        chain = []
        while True:
            chain.append(rng.integers(0, 256, (h, w, 4), dtype=np.uint8))
            if h == 1 and w == 1:
                break
            h, w = max(h // 2, 1), max(w // 2, 1)
        chains.append(chain)
    return chains


def two_texture_batch():
    """The demo batch with a second texture on every other instance's
    triangles (textures sized like ``seeded_chains``)."""
    batch = demo.build_demo_batch(instances=4, skinned=False)
    rng = np.random.default_rng(9)
    batch.textures = [rng.integers(0, 256, (37, 23, 4), dtype=np.uint8),
                      rng.integers(0, 256, (8, 8, 4), dtype=np.uint8)]
    batch.tri_texture = (np.arange(len(batch.tris)) // 12 % 2).astype(
        np.int32)
    return batch


def texel_rows(batch) -> int:
    """Logical rows of the batch's box-filter chains in a texel pool."""
    return sum(img.shape[0] * img.shape[1]
               for t in batch.textures for img in td.mip_chain(t))


# --------------------------------------------------------------- upload


@pytest.mark.parametrize("name", sorted(SCENES))
def test_narrow_upload_matches_jax_leaf_by_leaf(name):
    batch = SCENES[name]()
    ts = td.upload(batch, "narrow", device="cpu")
    assert ts.mip_pool.shape[-1] == 4
    assert_scene_equal(ts, jd.upload(batch, pool_mode="narrow"))


@pytest.mark.parametrize("mode", ["quad", "narrow", "tri"])
def test_mip_chains_upload_matches_jax(mode):
    """Given levels (not box-filter related, odd sizes) go into the pool
    as they are, the mip table and extents following them."""
    batch = two_texture_batch()
    chains = seeded_chains()
    ts = td.upload(batch, mode, device="cpu", mip_chains=chains)
    assert_scene_equal(ts, jd.upload(batch, pool_mode=mode,
                                     mip_chains=chains))
    assert ts.num_mips == 6 and tuple(ts.tex_size[0].tolist()) == (37, 23)


def test_mip_chains_must_cover_every_texture():
    with pytest.raises(ValueError, match="mip chains"):
        td.upload(two_texture_batch(), device="cpu",
                  mip_chains=seeded_chains()[:1])


@pytest.mark.parametrize("mode", ["quad", "tri"])
def test_pool_bias_one_matches_jax(mode):
    batch = two_texture_batch()
    ts = td.upload(batch, mode, device="cpu", pool_bias=1)
    assert_scene_equal(ts, jd.upload(batch, pool_mode=mode, pool_bias=1))
    assert ts.tex_size.tolist() == [[18, 11], [4, 4]]


@pytest.mark.parametrize("steps", [1, 2])
def test_pool_bias_auto_matches_jax_at_twice_the_budget(steps, caplog):
    """``pool_bias="auto"`` drops levels until the pool fits, one warning
    per step. The port charges the pool once and the reference twice, so
    the port at budget B takes the bias the reference takes at 2B."""
    batch = two_texture_batch()
    tables = [td.mip_chain(t) for t in batch.textures]
    rows = sum(img.shape[0] * img.shape[1]
               for c in tables for img in c[steps:])
    budget = rows * 16
    with caplog.at_level(logging.WARNING, logger="mt_renderer_tpu_torch"):
        ts = td.upload(batch, "quad", device="cpu", pool_bias="auto",
                       pool_budget_bytes=budget)
    assert sum("bias ->" in r.getMessage() for r in caplog.records) == steps
    assert_scene_equal(ts, jd.upload(batch, pool_mode="quad",
                                     pool_bias="auto",
                                     pool_budget_bytes=2 * budget))
    assert_scene_equal(ts, jd.upload(batch, pool_mode="quad",
                                     pool_bias=steps))
    # the reference at the port's budget drops one level more
    js = jd.upload(batch, pool_mode="quad", pool_bias="auto",
                   pool_budget_bytes=budget)
    assert js.num_mips == ts.num_mips - 1


def test_pool_bias_auto_unbudgeted_keeps_every_level():
    batch = two_texture_batch()
    ts = td.upload(batch, "quad", device="cpu", pool_bias="auto")
    assert_scene_equal(ts, jd.upload(batch, pool_mode="quad"))


# mipmap hint, budget as (bytes per logical row, offset) → the port's
# pick, the reference's pick at the same budget (it charges twice)
AUTO_CASES = [
    (True, (64, 0), "tri", "quad"),
    (True, (64, -1), "quad", "quad"),
    (True, (16, -1), "narrow", "narrow"),
    (False, (64, 0), "quad", "quad"),
    (False, (16, 0), "quad", "narrow"),
    (False, (16, -1), "narrow", "narrow"),
]


@pytest.mark.parametrize("mipmap,budget,want,jax_pick", AUTO_CASES)
def test_auto_picks_by_budget(mipmap, budget, want, jax_pick, caplog):
    """``pool_mode="auto"`` at budgets placed at the port's thresholds:
    the pick, its scene leaf by leaf against the reference's upload of
    that mode, and the reference's pick at the same budget."""
    batch = two_texture_batch()
    nbytes = texel_rows(batch) * budget[0] + budget[1]
    with caplog.at_level(logging.WARNING, logger="mt_renderer_tpu_torch"):
        ts = td.upload(batch, "auto", device="cpu", mipmap=mipmap,
                       pool_budget_bytes=nbytes)
    assert ts.pool_mode == want
    first = "tri" if mipmap else "quad"
    assert any("auto mode" in r.getMessage()
               for r in caplog.records) == (want != first)
    assert_scene_equal(ts, jd.upload(batch, pool_mode=want))
    js = jd.upload(batch, pool_mode="auto", mipmap=mipmap,
                   pool_budget_bytes=nbytes)
    assert js.pool_mode == jax_pick


def test_auto_unbudgeted_takes_the_first_choice():
    batch = two_texture_batch()
    assert td.upload(batch, "auto", device="cpu").pool_mode == "quad"
    assert td.upload(batch, "auto", device="cpu",
                     mipmap=True).pool_mode == "tri"


@pytest.mark.parametrize("mode,row_bytes", [
    ("quad", 16), ("narrow", 4), ("tri", 64), ("auto", 4)])
def test_over_budget_raises_memory_error(mode, row_bytes):
    """The pool fits at exactly its stored bytes and raises one byte
    below, for an explicit mode and for auto (whose last choice is
    narrow); the reference already raises at the stored bytes."""
    batch = two_texture_batch()
    need = texel_rows(batch) * row_bytes
    assert td.upload(batch, mode, device="cpu",
                     pool_budget_bytes=need).mip_pool.numel() > 0
    with pytest.raises(MemoryError, match="charged once"):
        td.upload(batch, mode, device="cpu", pool_budget_bytes=need - 1)
    with pytest.raises(MemoryError):
        jd.upload(batch, pool_mode=mode, pool_budget_bytes=need)


def test_pool_budget_default(monkeypatch):
    monkeypatch.delenv("MTR_POOL_BUDGET_MB", raising=False)
    assert td.pool_budget_default("cpu") is None
    monkeypatch.setenv("MTR_POOL_BUDGET_MB", "1.5")
    assert td.pool_budget_default("cpu") == int(1.5 * 2**20)
    batch = two_texture_batch()
    monkeypatch.setenv("MTR_POOL_BUDGET_MB", "0.01")
    with pytest.raises(MemoryError):
        td.upload(batch, "tri", device="cpu")


def test_scene_from_numpy_carries_the_narrow_pool():
    batch = two_texture_batch()
    leaves, statics = jax_leaves(jd.upload(batch, pool_mode="narrow"))
    carried = td.scene_from_numpy(leaves, statics, "cpu")
    own = td.upload(batch, "narrow", device="cpu")
    for f in td.TENSOR_FIELDS:
        assert torch.equal(getattr(carried, f), getattr(own, f)), f
    leaves["mip_pool"] = np.zeros((4, 16), np.uint8)
    with pytest.raises(ValueError, match="rows of 4 B"):
        td.scene_from_numpy(leaves, statics, "cpu")


# ---------------------------------------------------------- pool_stats


@pytest.mark.parametrize("mode", ["quad", "narrow", "tri", "bc1"])
def test_pool_stats_match_jax(mode):
    batch = two_texture_batch()
    got = td.pool_stats(td.upload(batch, mode, device="cpu"))
    assert got == jd.pool_stats(jd.upload(batch, pool_mode=mode))
    assert got["pool_mode"] == mode and got["src_texels"] == 37 * 23 + 64


# ------------------------------------------------------- set_parts_mask


@pytest.mark.parametrize("parts_disp", [
    [True, False] * 5, [False] * 3, [True] * 12 + [False] * 4])
def test_set_parts_mask_matches_jax(parts_disp):
    batch = SCENES["flat_colors"]()
    ts = td.upload(batch, device="cpu")
    js = jd.upload(batch)
    got = td.set_parts_mask(ts, parts_disp)
    want = jd.set_parts_mask(js, parts_disp)
    for f in ("parts_mask", "tri_vis"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert not bool(got.tri_vis.all()) and bool(got.tri_vis.any())
    # every other buffer is shared, not copied
    for f in td.TENSOR_FIELDS:
        if f not in ("parts_mask", "tri_vis"):
            assert getattr(got, f) is getattr(ts, f), f


def test_set_parts_mask_hides_triangles_in_the_frame():
    """Hiding every part leaves the clear color; showing them all again
    gives back the original frame."""
    batch = demo.build_demo_batch(instances=4, skinned=False)
    vp = np.asarray(demo.demo_camera(4, W, H).view_proj())
    ts = td.upload(batch, device="cpu")
    full, _ = td.render_frame(ts, vp, width=W, height=H, packed=True)
    hidden = td.set_parts_mask(ts, [False] * ts.parts_mask.shape[0])
    none, depth = td.render_frame(hidden, vp, width=W, height=H,
                                  packed=True)
    back, _ = td.render_frame(td.set_parts_mask(hidden, [True]), vp,
                              width=W, height=H, packed=True)
    tr.flush_overflow_checks()
    assert bool((none == -1).all()) and bool((depth == 1.0).all())
    assert torch.equal(back, full) and bool((full != -1).any())


# ---------------------------------------------- count_covered_textured


def test_count_covered_textured_matches_jax():
    """Untextured triangles on every third instance: the textured count
    is measured, not the covered one; both against JAX's (Pallas in
    interpret mode) at a tiny size."""
    batch = demo.build_demo_batch(instances=4, skinned=True, subdiv=1)
    per = len(batch.tris) // 4                 # triangles per instance
    batch.tri_texture = np.where(np.arange(len(batch.tris)) // per % 3 == 0,
                                 -1, batch.tri_texture).astype(np.int32)
    vp = np.asarray(demo.demo_camera(4, W, H).view_proj())
    bones = demo.demo_bone_mats(0.3)
    cov, tex = td.count_covered_textured(td.upload(batch, device="cpu"), vp,
                                         bones, width=W, height=H)
    jcov, jtex = jd.count_covered_textured(
        jd.upload(batch), jnp.asarray(vp), jnp.asarray(bones), width=W,
        height=H)
    assert cov.dtype == tex.dtype == torch.int32
    assert (int(cov), int(tex)) == (int(jcov), int(jtex))
    assert 0 < int(tex) < int(cov) < W * H


def test_count_covered_textured_reads_the_frame():
    """The counts equal the coverage and textured share read from the
    same view's frame at 200x100 (cropped from its padded tiles)."""
    batch = demo.build_demo_batch(instances=9, skinned=True, subdiv=1)
    vp = np.asarray(demo.demo_camera(9, 200, 100).view_proj())
    bones = demo.demo_bone_mats(0.5)
    ts = td.upload(batch, "bc1", device="cpu")
    cov, tex = td.count_covered_textured(ts, vp, bones, width=200,
                                         height=100)
    _, depth = td.render_frame(ts, vp, bones, width=200, height=100,
                               mipmap=True)
    tr.flush_overflow_checks()
    assert int(cov) == int((depth < 1.0).sum()) == int(tex) > 0


# ------------------------------------------------------- narrow frames


@pytest.mark.parametrize("lighting", [False, True])
def test_narrow_mip_frame_equals_quad(lighting):
    batch = two_texture_batch()
    vp = np.asarray(demo.demo_camera(4, W, H).view_proj())
    kw = dict(width=W, height=H, packed=True, mipmap=True,
              lighting=lighting,
              tap_tiles=td.auto_tap_tiles(batch, vp, width=W, height=H))
    quad, qd = td.render_frame(td.upload(batch, device="cpu"), vp, **kw)
    narrow, nd = td.render_frame(td.upload(batch, "narrow", device="cpu"),
                                 vp, **kw)
    tr.flush_overflow_checks()
    assert torch.equal(narrow, quad) and torch.equal(nd, qd)
    assert bool((qd < 1.0).any())


@pytest.mark.parametrize("peel_mode", ["split", "ml"])
def test_narrow_peeled_mip_frame_equals_quad(peel_mode):
    batch = demo.make_translucent(demo.build_demo_batch(
        instances=8, skinned=True, subdiv=1), 8)
    cam = demo.demo_camera(8, W, H)
    cam.position = cam.position * 0.3
    vp, bones = np.asarray(cam.view_proj()), demo.demo_bone_mats(0.4)
    kw = dict(width=W, height=H, layers=3, peel_mode=peel_mode,
              packed=True, mipmap=True, lighting=True)
    quad, _ = td.render_frame_peeled(td.upload(batch, device="cpu"), vp,
                                     bones, **kw)
    narrow, _ = td.render_frame_peeled(
        td.upload(batch, "narrow", device="cpu"), vp, bones, **kw)
    tr.flush_overflow_checks()
    assert torch.equal(narrow, quad)


def test_narrow_tap_paths_raise():
    """The bilinear tap paths need quad rows: the frame, the peeled frame
    and the peeled tap composite itself refuse a narrow pool, naming the
    quad pool."""
    batch = demo.make_translucent(demo.build_demo_batch(
        instances=4, skinned=False), 4)
    ts = td.upload(batch, "narrow", device="cpu")
    vp = np.asarray(demo.demo_camera(4, W, H).view_proj())
    with pytest.raises(ValueError, match="quad"):
        td.render_frame(ts, vp, width=W, height=H)
    for mode in ("split", "ml"):
        with pytest.raises(ValueError, match="quad"):
            td.render_frame_peeled(ts, vp, width=W, height=H, layers=2,
                                   peel_mode=mode)
    nt = (W // tr.TILE_W) * (H // tr.TILE_H)
    with pytest.raises(ValueError, match="quad"):
        td.composite_peeled_tap_flat(
            ts, torch.zeros(nt, 2 * tr.ATTRS_TAP, tr.P),
            torch.zeros(nt, 2, tr.P, dtype=torch.int32),
            torch.zeros(nt, 2, tr.P, dtype=torch.int32), 2, (0, 0, 0, 0))
