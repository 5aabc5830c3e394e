"""Port vs reference: binning (bit for bit), the host predictors pinned
to the port's own binning, and loud overflow.

Tolerance: none — binning is integer bookkeeping over the same f32
bboxes, so lists, glists, counts, counts_true and n_over must be
identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt_renderer_tpu.app.camera import Camera
from mt_renderer_tpu.render import pallas_raster as pr
from mt_renderer_tpu.scene import demo
from mt_renderer_tpu.scene.model import DrawBatch
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr


def _random_bbox(seed: int, chunks: int = 9):
    """Seeded group bboxes over a 256x128 grid with invalid groups
    (+-1e30, as setup emits them) and duplicated chunk depths (ties in
    the nearest-first sort)."""
    rng = np.random.default_rng(seed)
    cg = chunks * tr.G
    x0 = rng.uniform(-60, 300, cg).astype(np.float32)
    y0 = rng.uniform(-30, 150, cg).astype(np.float32)
    xmin, ymin = x0, y0
    xmax = (x0 + rng.exponential(40, cg)).astype(np.float32)
    ymax = (y0 + rng.exponential(20, cg)).astype(np.float32)
    zmin = rng.choice(np.float32([0.1, 0.25, 0.5, 0.75]), cg)
    zmin = (zmin + rng.integers(0, 3, cg) * 0.01).astype(np.float32)
    dead = rng.uniform(size=cg) < 0.3
    big = np.float32(1e30)
    xmin = np.where(dead, big, xmin)
    ymin = np.where(dead, big, ymin)
    zmin = np.where(dead, big, zmin)
    xmax = np.where(dead, -big, xmax)
    ymax = np.where(dead, -big, ymax)
    return tuple(np.ascontiguousarray(a, np.float32)
                 for a in (xmin, xmax, ymin, ymax, zmin))


@pytest.mark.parametrize("maxc", [9, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bin_chunks_bit_exact(seed, maxc):
    bbox = _random_bbox(seed)
    n_ty, n_tx = 8, 2
    want = pr.bin_chunks(tuple(jnp.asarray(b) for b in bbox), n_ty, n_tx,
                         maxc, 0, 0)
    got = tr.bin_chunks(tuple(torch.from_numpy(b) for b in bbox), n_ty,
                        n_tx, maxc, 0, 0)
    for name, g, w in zip(("lists", "glists", "counts", "counts_true"),
                          got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    n_over = int((got[3] > maxc).sum())
    assert n_over == int(jnp.sum(want[3] > maxc))
    if maxc == 2:
        assert n_over > 0, "this case is meant to overflow"


def test_prebin_band_origin_bit_exact():
    """A band whose tile grid starts below the frame's top row."""
    bbox = _random_bbox(4)
    cols = torch.zeros((tr.N_RAST + tr.N_COEF, 9 * tr.CT))
    got = tr.prebin(cols, tuple(torch.from_numpy(b) for b in bbox), 0, 64,
                    width=256, height=64, maxc=3)
    want = pr.bin_chunks(tuple(jnp.asarray(b) for b in bbox), 4, 2, 3, 0, 64)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[3]) == int(jnp.sum(want[3] > 3))


def _random_batch(seed: int) -> DrawBatch:
    rng = np.random.default_rng(seed)
    nt = int(rng.integers(50, 2500))
    pos = rng.uniform(-1.5, 1.5, (3 * nt, 3)).astype(np.float32)
    return DrawBatch(
        positions=pos,
        uvs=np.zeros((3 * nt, 2), np.float32),
        joints=np.zeros((3 * nt, 4), np.int32),
        weights=np.zeros((3 * nt, 4), np.float32),
        tris=np.arange(3 * nt, dtype=np.int32).reshape(nt, 3),
        tri_texture=np.full(nt, -1, np.int32),
        tri_parts=np.zeros(nt, np.int32),
        tri_debug_id=np.zeros(nt, np.int32),
    )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_auto_maxc_pins_bin_chunks(seed):
    """The NumPy predictor at margin=1.0 equals the port's true per-tile
    candidate counts on randomized scenes, tile by tile."""
    batch = _random_batch(seed)
    width, height = 256, 128
    vp = np.asarray(Camera(position=[0, 0, 3.5]).view_proj())
    amc = td.auto_maxc(batch, vp, None, width=width, height=height,
                       margin=1.0)
    scene = td.upload(batch, device="cpu")
    clip = td.vertex_stage(scene, vp, None)
    _, bbox = td.setup_packed_cols(scene, clip, width, height)
    _, _, _, counts_true = tr.bin_chunks(
        bbox, height // tr.TILE_H, width // tr.TILE_W, 1, 0, 0)
    req = int(counts_true.max())
    assert req > 0, "degenerate scene — nothing binned"
    assert amc == max(8, -(-req // 8) * 8)
    pred = td.predict_bin_counts(batch, vp, None, width=width, height=height)
    np.testing.assert_array_equal(pred.reshape(-1), counts_true.numpy())


def test_auto_maxc_is_not_clamped():
    """The TPU's SMEM clamp is gone: a cap above its limit stays."""
    batch = demo.build_demo_batch(instances=64, skinned=False)
    vp = np.asarray(demo.demo_camera(64, 128, 64).view_proj())
    need = int(td.predict_bin_counts(batch, vp, None, width=128,
                                     height=64).max())
    assert td.auto_maxc(batch, vp, None, width=128, height=64,
                        margin=100.0) >= need * 100


def _dense_frame(**kw):
    batch = demo.build_demo_batch(instances=64, skinned=False)
    vp = np.asarray(demo.demo_camera(64, 128, 64).view_proj())
    scene = td.upload(batch, device="cpu")
    return td.render_frame(scene, vp, None, width=128, height=64, **kw)


def test_bin_overflow_warns_loudly():
    before = tr.OVERFLOW_EVENTS
    with pytest.warns(RuntimeWarning, match="bin overflow"):
        _dense_frame(maxc=1)
        tr.flush_overflow_checks()
    assert tr.OVERFLOW_EVENTS > before


def test_tap_overflow_warns_loudly():
    """The packed frame compacts its taps (the unpacked bilinear frame
    shades every row and ignores ``tap_tiles``, as the reference's)."""
    before = tr.OVERFLOW_EVENTS
    with pytest.warns(RuntimeWarning, match="tap overflow"):
        _dense_frame(tap_tiles=1, packed=True)
        tr.flush_overflow_checks()
    assert tr.OVERFLOW_EVENTS > before


def test_strict_overflow_raises(monkeypatch):
    monkeypatch.setenv("MTR_STRICT_OVERFLOW", "1")
    _dense_frame(maxc=1)
    with pytest.raises(RuntimeError, match="bin overflow"):
        tr.flush_overflow_checks()


def test_overflow_queue_compresses_on_device():
    for _ in range(tr._COMPRESS + 3):
        tr.queue_overflow_check(torch.tensor(0, dtype=torch.int32), 8,
                                what="bin overflow: test")
    tr.queue_overflow_check(torch.tensor(2, dtype=torch.int32), 8,
                            what="bin overflow: test")
    assert len(tr._PENDING["bin overflow: test"]) < tr._COMPRESS
    assert tr.flush_overflow_counts() == {"bin overflow: test": (2, 8)}
    assert tr.flush_overflow_counts() == {}
