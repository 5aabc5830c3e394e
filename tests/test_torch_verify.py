"""The reference bench's verify legs on the port (``verify.bench_legs``).

On CPU tensors every leg runs through the plain versions of K1 and K2
(the ``scan`` and ``peel_scan`` legs through the scan backend, plain
PyTorch everywhere).
- Every leg passes at a small size and at the reference's (256x256, 9
  instances at subdiv 2).
- Each leg fails when its frame is perturbed: one pixel's color for the
  legs held bit for bit, one covered pixel's depth (a coverage mismatch
  off the oracle's coverage edge) for the legs held under a bound.
- The ``pallas`` leg's frame matches the JAX package's
  ``render_frame(backend="pallas", packed=True)`` of the same scene:
  coverage exact, depth within 1e-5, color under the golden rule and
  bit-equal on more than 99% of pixels (as ``test_torch_frame.py`` holds
  the packed frame).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.scene import demo as jdemo
from mt_renderer_tpu_torch import verify
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr
from torch_threads import one_thread  # noqa: F401

SMALL = dict(width=64, height=64, instances=4, subdiv=1)
LEGS = ("scan", "pallas", "peel_scan", "peel_pallas", "packed",
        "peel_packed", "mipmap_packed", "peel_split", "multichip_1dev")


@pytest.fixture(scope="module")
def small():
    return verify.bench_frames("cpu", **SMALL)


def test_bench_legs_pass_at_a_small_size():
    r = verify.bench_legs("cpu", **SMALL)
    assert set(r) == set(LEGS) | {"passed"}
    assert r["passed"] and all(r[leg]["passed"] for leg in LEGS), r
    assert 0.0 < r["pallas"]["coverage"] < 1.0
    assert not tr.OVERFLOW_EVENTS


def test_bench_legs_pass_at_the_reference_size():
    """256x256, 9 instances at subdiv 2: the peel's caps compact (fewer
    (tile, layer) rows than the grid's), as on the card."""
    r = verify.bench_legs("cpu")
    assert r["passed"], r
    assert r["peel_packed"]["tap_tiles"] < 3 * 2 * 16
    assert isinstance(r["peel_split"]["tap_tiles"], tuple)


def _interior_pixel(frames) -> tuple:
    """A pixel the oracle covers, off its coverage edge."""
    _, want_d = frames["oracle"]
    cov = want_d < 1.0
    ys, xs = np.nonzero(cov & ~verify.coverage_edge(cov))
    return int(ys[len(ys) // 2]), int(xs[len(xs) // 2])


# the frame each leg reads, and how it is perturbed
PERTURB = {
    "scan": ("scan", "depth"),
    "pallas": ("pallas", "depth"),
    "peel_scan": ("peel_scan", "depth"),
    "peel_pallas": ("peel_pallas", "depth"),
    "packed": ("packed", "color"),
    "peel_packed": ("peel_packed", "color"),
    "mipmap_packed": ("mipmap_packed", "depth"),
    "peel_split": ("peel_split", "color"),
    "multichip_1dev": ("multichip_1dev", "depth"),
}


@pytest.mark.parametrize("leg", LEGS)
def test_each_leg_fails_on_a_perturbed_frame(small, leg):
    frames, caps = small
    assert verify.judge_bench_legs(frames, caps)[leg]["passed"]
    name, what = PERTURB[leg]
    color, depth = (x.clone() for x in frames[name])
    y, x = _interior_pixel(frames)
    if what == "color":
        color[y, x] ^= 0x7F
    else:
        depth[y, x] = 1.0
    bad = verify.judge_bench_legs(dict(frames, **{name: (color, depth)}),
                                  caps)
    assert not bad[leg]["passed"] and not bad["passed"]


def test_pallas_leg_frame_matches_jax(small):
    """The port's ``pallas`` frame against the JAX package's packed
    frame (Pallas in interpret mode) at the same size, view and bones,
    as ``test_torch_frame.py`` holds the packed frame: coverage exact,
    color under the golden rule and bit-equal on more than 99% of pixels
    (the vertex stage, the plane sums and the bilinear contraction round
    in another order than XLA's: depth within 1e-5)."""
    frames, _ = small
    w, h, n = SMALL["width"], SMALL["height"], SMALL["instances"]
    batch = jdemo.build_demo_batch(instances=n, skinned=True,
                                   subdiv=SMALL["subdiv"])
    vp = jnp.asarray(np.asarray(jdemo.demo_camera(n, w, h).view_proj()))
    bones = jnp.asarray(jdemo.demo_bone_mats(0.6))
    want, want_d = jd.render_frame(jd.upload(batch), vp, bones, width=w,
                                   height=h, backend="pallas", packed=True)
    got, got_d = frames["pallas"]
    np.testing.assert_array_equal(got_d.numpy() < 1.0,
                                  np.asarray(want_d) < 1.0)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0,
                               atol=1e-5)
    assert bool((got_d < 1.0).any())
    got_u8 = td.unpack_rgba(got)
    want_u8 = jd.unpack_rgba(np.asarray(want))
    diff = np.abs(got_u8.astype(np.int32) - want_u8.astype(np.int32))
    assert (diff.max(-1) > 1).mean() <= verify.SHARE
    assert (got.numpy().view(np.uint32) == np.asarray(want)).mean() > 0.99


def test_bench_legs_report_the_frames_device():
    frames, _ = verify.bench_frames("cpu", **SMALL)
    for name, (color, depth) in frames.items():
        if name != "oracle":
            assert isinstance(color, torch.Tensor) and color.dtype == \
                torch.int32 and depth.device.type == "cpu", name
