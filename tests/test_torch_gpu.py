"""The hand-written CUDA kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA device and skips without one (decided in the
``cuda`` fixture, so every pytest worker collects the same tests). The
file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerance: none. K1 is built without FMA contraction, so it rounds
every plane evaluation like the plain version's separate ops: all four
outputs are expected bit-equal.
"""

import numpy as np
import pytest
import torch

from mt_renderer_tpu.scene import demo
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr

W, H = 256, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _binned(device, *, maxc=None, instances=9, subdiv=2, width=W,
            height=H):
    """The port's own vertex, setup and binning stages on ``device`` →
    the raster's positional arguments."""
    batch = demo.build_demo_batch(instances=instances, skinned=True,
                                  subdiv=subdiv)
    vp = np.asarray(demo.demo_camera(instances, width, height).view_proj())
    bones = demo.demo_bone_mats(0.5)
    if maxc is None:
        maxc = td.auto_maxc(batch, vp, bones, width=width, height=height)
    scene = td.upload(batch, device=device)
    cols, bbox = td.setup_packed_cols(
        scene, td.vertex_stage(scene, vp, bones), width, height)
    lists, glists, counts, n_over = tr.prebin(cols, bbox, 0, 0, width=width,
                                              height=height, maxc=maxc)
    return (cols, lists, glists, counts, (0, 0)), n_over


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    dict(),
    # 64 instances piled into few tiles: maxc=1 drops chunks
    dict(maxc=1, instances=64, subdiv=0, width=128, height=64),
], ids=["auto_maxc", "overflowing"])
def test_kernel_matches_plain_version(cuda, case):
    """Auto-sized and overflowing chunk lists."""
    args, n_over = _binned(cuda, **case)
    kw = dict(width=case.get("width", W), height=case.get("height", H),
              w_eps=td.W_EPS)
    before = tr.raster_fwd.launches
    got = tr.raster_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert tr.raster_fwd.launches == before + 1
    assert (int(n_over) > 0) == ("maxc" in case)
    want = tr.raster_fwd_reference(*args, **kw)
    assert 0.05 < float((want[1] >= 0).float().mean()) < 0.95
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_kernel_band_origin_and_empty_tiles(cuda):
    """A band with a nonzero origin whose tiles have empty lists."""
    (cols, *_), _ = _binned(cuda)
    bbox = tuple(torch.full((cols.shape[1] // tr.KG,), v, device=cuda)
                 for v in (1e30, -1e30, 1e30, -1e30, 1e30))
    lists, glists, counts, _ = tr.prebin(cols, bbox, 128, 32, width=128,
                                         height=32, maxc=4)
    zb, ib, tattrs, tapidx = tr.raster_fwd(
        cols, lists, glists, counts, (128, 32), width=128, height=32,
        w_eps=td.W_EPS)
    torch.cuda.synchronize()
    assert (ib == -1).all() and (zb == 1.0).all()
    assert (tapidx == 0).all() and (tattrs == 0).all()


@pytest.mark.gpu
def test_packed_frame_on_card_matches_cpu(cuda):
    """The whole packed frame on the card against the same frame on the
    CPU (plain raster): coverage exact, at most 0.3% of pixels with a
    channel off by more than 1."""
    batch = demo.build_demo_batch(instances=9, skinned=True, subdiv=2)
    vp = np.asarray(demo.demo_camera(9, W, H).view_proj())
    bones = demo.demo_bone_mats(0.5)
    maxc = td.auto_maxc(batch, vp, bones, width=W, height=H)
    taps = td.auto_tap_tiles(batch, vp, bones, width=W, height=H)
    out = {}
    for dev in ("cpu", cuda):
        out[str(dev)] = td.render_frame(
            td.upload(batch, device=dev), vp, bones, width=W, height=H,
            packed=True, maxc=maxc, tap_tiles=taps)
    tr.flush_overflow_checks()
    (gc, gd), (wc, wd) = out["cuda"], out["cpu"]
    assert gc.device.type == "cuda" and gc.dtype == torch.int32
    assert torch.equal(gd.cpu() < 1.0, wd < 1.0)
    diff = np.abs(td.unpack_rgba(gc).astype(np.int32)
                  - td.unpack_rgba(wc).astype(np.int32)).max(-1)
    assert (diff > 1).mean() <= 0.003
