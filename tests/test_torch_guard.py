"""The frame engine's cap guard on the scene's device (``device.guard_counts``
and ``FrameEngine._guard``), on the CPU at test size.

Three cases: the demo cubes (quad pool, the palette a NumPy array), the
archive world (tri pool, trilinear, the palette posed on the device by
``bone_mats_device``) and the glass demo (every 4th instance translucent,
the camera inside the field, the split peel). On each:

- the bin need (``guard_counts[0]``) equals ``raster.bin_chunks``'
  uncapped per-tile count's largest value on the frame's own
  ``setup_packed_cols`` boxes, exactly;
- the row bound (``guard_counts[1]``) is at least the tap rows the
  frame's raster finds live (a covered pixel with ``tapidx >= 0``) and
  at most the grid's rows;
- a 6-frame orbit through ``FrameEngine(interactive=True)``, closing in
  on the scene, queues no overflow and renders each frame as
  ``render_frame`` (or ``render_frame_peeled``) renders it at the
  engine's caps, with no host predictor on the path;
- the world's device palette is never copied to the host by the guard.

Tolerance: none, every comparison exact.
"""

import numpy as np
import pytest
import torch

from mt_renderer_tpu_torch import entry
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import engine as te
from mt_renderer_tpu_torch.render import raster as tr
from mt_renderer_tpu_torch.scene import demo
from mt_renderer_tpu_torch.utils import profiling
from torch_threads import one_thread  # noqa: F401

W, H = 256, 128
CASES = ("demo", "world", "glass")
FRAMES = 6


class Case:
    """A scene, its host batch, the engine's frame options and an orbit
    that closes in: ``view(i)`` → (view_proj, bone_mats) of frame i."""

    def __init__(self, name: str):
        self.name = name
        self.peel = 3 if name == "glass" else 0
        self.mipmap = name == "world"
        if name == "world":
            self.world = entry.world_case(
                "cpu", buildings=24, width=W, height=H, characters=4,
                variants=3, terrain_subdiv=8, building_subdivs=(4,))
            self.batch, self.scene = self.world.batch, self.world.scene
            self.camera = self.world.camera
        else:
            batch = demo.build_demo_batch(instances=64, skinned=True,
                                          subdiv=2)
            if name == "glass":
                batch = demo.make_translucent(batch, 64)
            self.batch = batch
            self.scene = td.upload(batch, device="cpu")
            self.camera = demo.demo_camera(64, W, H)
            if name == "glass":
                self.camera.position = self.camera.position * 0.5
        self.start = np.array(self.camera.position, dtype=np.float64)

    def view(self, i: int):
        self.camera.yaw = 10.0 + 4.0 * i
        self.camera.position = self.start * (1.0 - 0.1 * i)
        vp = np.asarray(self.camera.view_proj())
        if self.name == "world":
            return vp, self.world.bone_mats_device(3.0 * i)
        return vp, demo.demo_bone_mats(0.3 * i)

    def engine(self) -> te.FrameEngine:
        return te.FrameEngine(self.scene, self.batch, width=W, height=H,
                              mipmap=self.mipmap, peel=self.peel,
                              interactive=True)

    def frame(self, eng: te.FrameEngine, vp, bones):
        kw = dict(width=W, height=H, maxc=eng.maxc, mipmap=self.mipmap,
                  packed=eng.packed, tap_tiles=eng.tap_tiles,
                  check_overflow=False)
        if self.peel:
            return td.render_frame_peeled(self.scene, vp, bones,
                                          layers=self.peel,
                                          peel_mode="split", **kw)
        return td.render_frame(self.scene, vp, bones, **kw)


@pytest.fixture(scope="module", params=CASES)
def case(request):
    return Case(request.param)


@pytest.fixture(autouse=True)
def _clean():
    yield
    tr.flush_overflow_checks()
    profiling.reset_spans()


def frame_setup(case: Case, vp, bones):
    clip = td.vertex_stage(case.scene, vp, bones)
    return td.setup_packed_cols(case.scene, clip, W, H)


@pytest.mark.parametrize("i", [0, 3, 5])
def test_the_bin_need_is_bin_chunks_count(case, i):
    vp, bones = case.view(i)
    _, bbox = frame_setup(case, vp, bones)
    counts_true = tr.bin_chunks(bbox, H // tr.TILE_H, W // tr.TILE_W, 1,
                                0, 0)[3]
    got = td.guard_counts(case.scene, vp, bones, width=W, height=H)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2,)
    assert int(counts_true.max()) > 0, "nothing binned"
    assert int(got[0]) == int(counts_true.max())


@pytest.mark.parametrize("i", [0, 3, 5])
def test_the_row_bound_covers_the_live_tap_rows(case, i):
    vp, bones = case.view(i)
    cols, bbox = frame_setup(case, vp, bones)
    lists, glists, counts, _ = tr.prebin(cols, bbox, 0, 0, width=W,
                                         height=H, maxc=10**6)
    _, ib, _, tapidx = tr.raster_fwd(cols, lists, glists, counts, (0, 0),
                                     width=W, height=H, w_eps=td.W_EPS)
    live = (ib[:, 0, :] >= 0) & (tapidx[:, 0, :] >= 0)
    live = int(live.reshape(-1, td.SEG_PX).any(1).sum())
    bound = int(td.guard_counts(case.scene, vp, bones, width=W,
                                height=H)[1])
    assert 0 < live <= bound <= td._seg_rows_of(W, H)


def counted_checks(eng: te.FrameEngine) -> list:
    """The overflow counts of every check the engine makes, from now."""
    over = []
    check = eng.check

    def counted(*a, **k):
        counts = check(*a, **k)
        over.extend(n for n, _ in counts.values() if n > 0)
        return counts

    eng.check = counted
    return over


def test_an_orbit_queues_no_overflow_and_renders_the_frame(case,
                                                           monkeypatch):
    """Six frames turning and closing in: every frame is the one
    ``render_frame`` renders at the engine's caps, each cap at least its
    need, no overflow queued, and no host predictor on the path."""

    def host_predictor(*a, **k):
        raise AssertionError("a host predictor ran on the engine's path")

    monkeypatch.setattr(td, "_chunk_bboxes", host_predictor)
    eng = case.engine()
    over = counted_checks(eng)
    for i in range(FRAMES):
        vp, bones = case.view(i)
        got, got_d = eng.render(vp, bones)
        want, want_d = case.frame(eng, vp, bones)
        assert torch.equal(got, want) and torch.equal(got_d, want_d), i
        need = int(td.guard_counts(case.scene, vp, bones, width=W,
                                   height=H)[0])
        assert eng.maxc >= need
    assert over == []


def test_the_world_palette_stays_on_the_device(monkeypatch):
    """The guard counts from the world's device palette where it lies:
    no tensor is copied to the host during ``_guard`` (the counts come
    back by ``tolist``)."""
    case = Case("world")
    eng = case.engine()
    eng.render(*case.view(0))                 # sizes
    calls = []
    inside = [False]
    cpu, numpy = torch.Tensor.cpu, torch.Tensor.numpy

    def counted(orig):
        def f(self, *a, **k):
            if inside[0]:
                calls.append(orig.__name__)
            return orig(self, *a, **k)
        return f

    guard = eng._guard

    def watched(*a, **k):
        inside[0] = True
        try:
            return guard(*a, **k)
        finally:
            inside[0] = False

    monkeypatch.setattr(torch.Tensor, "cpu", counted(cpu))
    monkeypatch.setattr(torch.Tensor, "numpy", counted(numpy))
    eng._guard = watched
    for i in range(1, 3):
        vp, bones = case.view(i)
        assert isinstance(bones, torch.Tensor)
        eng.render(vp, bones)
    assert calls == []


def test_the_guard_grows_the_caps_before_the_frame(tmp_path):
    """Caps set below this view's needs: the guard grows both before the
    frame (``guard.grow`` twice, inside ``engine.guard``), the frame is
    ``render_frame``'s at the grown caps and queues no overflow; the next
    frame at the same view counts (``guard.count``) and grows nothing."""
    case = Case("demo")
    eng = case.engine()
    vp, bones = case.view(5)
    eng.render(vp, bones)                     # sizes at this view
    need, live = td.guard_counts(case.scene, vp, bones, width=W,
                                 height=H).tolist()
    assert need >= 2 and live >= 9
    eng.maxc, eng.tap_tiles, eng._tap_bound = need - 1, 8, 0
    over = counted_checks(eng)
    with profiling.trace(str(tmp_path)):
        got, _ = eng.render(vp, bones)
        calls = {k: n for k, (n, _) in profiling.span_totals().items()}
        assert calls["engine.guard"] == calls["guard.count"] == 1
        assert calls["guard.grow"] == 2
        eng.render(vp, bones)
    calls = {k: n for k, (n, _) in profiling.span_totals().items()}
    assert calls["guard.count"] == 2 and calls["guard.grow"] == 2
    assert eng.maxc == te._cap(need, eng.headroom) >= need
    assert eng.tap_tiles == te._cap(live, eng.headroom, td._seg_rows_of(W, H))
    assert eng.recoveries == 2 and over == []
    want, _ = case.frame(eng, vp, bones)
    assert torch.equal(got, want)


@pytest.mark.parametrize("count,margin,hi,want", [
    (0, 1.5, None, 8), (5, 1.5, None, 8), (6, 1.5, None, 16),
    (16, 1.0, None, 16), (17, 1.0, None, 24), (100, 1.5, 64, 64),
    (3, 1.25, 4, 4)])
def test_the_caps_round_as_the_host_sizers_do(count, margin, hi, want):
    """``ceil(count x margin)`` rounded up to a multiple of 8, at least 8
    and at most the grid's rows: ``auto_maxc``'s and ``auto_tap_tiles``'
    rule."""
    assert te._cap(count, margin, hi) == want
