"""The port's named spans (``utils.profiling.span``) on the CPU, at small
sizes.

Off (no profiler recording), ``span`` hands back one shared null
context and records nothing. Under ``profiling.trace``:

- the eager single-layer frame's Chrome trace holds each ``frame.*``
  stage once, with K1's op inside ``frame.raster``;
- a guarded ``FrameEngine`` frame records ``engine.guard``,
  ``engine.frame`` and ``engine.check`` once, and ``guard.count`` (the
  counts on the device and their one readback) once inside
  ``engine.guard``, with a host or a device palette; ``guard.grow``
  opens only when the guard grows a cap, and no host predictor's
  ``predict.*`` span opens;
- a served request records ``serve.request`` around ``serve.inputs``,
  ``serve.step`` and ``serve.queue``, once each;
- a bc7 pool's frame opens ``shade.bc7`` inside ``frame.shade`` once a
  shade, and counts ``bc7.texels`` (``profiling.count``): the shaded
  rows' pixels times the trilinear tap's eight texels; a bc1 pool's
  frame likewise ``shade.bc1`` and ``bc1.texels``; a tri frame, of the
  demo or of the world, records neither, and off, neither is recorded.

The exported graph holds no profiler op, even when exported under a
profiler. The card's half (K1's kernel launched inside ``frame.raster``
on the profiler's clock) runs in ``chip_smoke.py`` (s3).
"""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mt_renderer_tpu_torch import entry, serving
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr
from mt_renderer_tpu_torch.render.engine import FrameEngine
from mt_renderer_tpu_torch.scene import demo
from mt_renderer_tpu_torch.utils import profiling
from torch_threads import one_thread  # noqa: F401

W, H = 128, 64
FRAME_SPANS = ("frame.vertex", "frame.setup", "frame.prebin",
               "frame.raster", "frame.shade", "frame.unflatten")
SERVE_SPANS = ("serve.request", "serve.inputs", "serve.step", "serve.queue")
LEAVES = ("guard.count", "guard.grow")


@pytest.fixture(scope="module")
def case():
    batch = demo.build_demo_batch(instances=4, skinned=True, subdiv=1)
    return (batch, td.upload(batch, device="cpu"),
            np.asarray(demo.demo_camera(4, W, H).view_proj()),
            demo.demo_bone_mats(0.4))


@pytest.fixture(autouse=True)
def _clean():
    profiling.reset_spans()
    yield
    profiling.reset_spans()
    tr.flush_overflow_checks()


def trace_events(log_dir) -> list:
    path = Path(log_dir) / profiling.TRACE_FILE
    return json.loads(path.read_text())["traceEvents"]


def annotations(events, name: str) -> list:
    return [e for e in events if e.get("name") == name
            and e.get("cat") == "user_annotation"]


def inside(inner: dict, outer: dict) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_off_it_is_one_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("engine.guard"), profiling.span("frame.raster")
    assert a is b
    with a as got:
        assert got is None
    assert profiling.span_totals() == {}


def test_off_no_frame_records_a_span(case):
    batch, scene, vp, bones = case
    eng = FrameEngine(scene, batch, width=W, height=H, interactive=True)
    for _ in range(2):
        eng.render(vp, bones)
    td.render_frame(scene, vp, bones, width=W, height=H)
    assert profiling.span_totals() == {}


def test_on_the_table_counts_calls_and_host_seconds(tmp_path):
    profiling._TOTALS["stale"] = [3, 10**9]
    with profiling.trace(str(tmp_path)):
        for _ in range(2):
            with profiling.span("engine.check"):
                time.sleep(0.01)
        with profiling.span("predict.bins"):
            pass
    got = profiling.span_totals()
    assert set(got) == {"engine.check", "predict.bins"}   # reset on entry
    assert got["engine.check"][0] == 2 and got["engine.check"][1] >= 0.02
    assert got["predict.bins"][0] == 1
    assert len(annotations(trace_events(tmp_path), "engine.check")) == 2
    profiling.reset_spans()
    assert profiling.span_totals() == {}


@pytest.mark.parametrize("mipmap", [False, True])
def test_an_eager_frame_holds_each_stage_once(tmp_path, case, mipmap):
    batch, scene, vp, bones = case
    if mipmap:
        scene = td.upload(batch, "tri", device="cpu")
    with profiling.trace(str(tmp_path)) as log_dir:
        td.render_frame(scene, vp, bones, width=W, height=H, mipmap=mipmap)
    events = trace_events(log_dir)
    spans = {s: annotations(events, s) for s in FRAME_SPANS}
    assert {s: len(v) for s, v in spans.items()} == dict.fromkeys(
        FRAME_SPANS, 1)
    op = "mtr::raster_fwd_mtap" if mipmap else "mtr::raster_fwd_tap"
    k1 = [e for e in events if e.get("name") == op]
    assert len(k1) == 1 and inside(k1[0], spans["frame.raster"][0])
    assert not inside(k1[0], spans["frame.shade"][0])
    assert set(profiling.span_totals()) == set(FRAME_SPANS)


@pytest.mark.parametrize("palette", ["host", "device"])
def test_a_guarded_engine_frame(tmp_path, case, palette):
    batch, scene, vp, bones = case
    if palette == "device":
        bones = torch.as_tensor(bones)
    eng = FrameEngine(scene, batch, width=W, height=H, interactive=True)
    eng.render(vp, bones)                     # sizes; no guard
    with profiling.trace(str(tmp_path)) as log_dir:
        eng.render(vp, bones)
    got = profiling.span_totals()
    calls = {k: n for k, (n, _) in got.items()}
    assert calls["engine.guard"] == calls["engine.frame"] == 1
    assert calls["engine.check"] == 1
    assert calls["guard.count"] == 1
    assert "guard.grow" not in calls          # the sized view: no growth
    assert not [k for k in calls if k.startswith("predict.")]
    leaves = sum(got[k][1] for k in LEAVES if k in got)
    assert 0.0 < leaves <= got["engine.guard"][1]
    events = trace_events(log_dir)
    guard = annotations(events, "engine.guard")[0]
    for k in LEAVES:
        assert all(inside(e, guard) for e in annotations(events, k))
    frame = annotations(events, "engine.frame")[0]
    assert inside(annotations(events, "frame.raster")[0], frame)


@pytest.fixture(scope="module")
def artifact(case):
    _, scene, _, _ = case
    return serving.load_render(serving.export_render(scene, width=W,
                                                     height=H))


def test_a_served_request_holds_its_four_spans(tmp_path, case, artifact):
    _, scene, vp, bones = case
    artifact(scene, vp, bones)                # first call outside the trace
    with profiling.trace(str(tmp_path)) as log_dir:
        artifact(scene, vp, bones)
    got = profiling.span_totals()
    assert {k: got[k][0] for k in SERVE_SPANS} == dict.fromkeys(
        SERVE_SPANS, 1)
    assert not any(k.startswith("frame.") for k in got)   # in the graph
    events = trace_events(log_dir)
    request = annotations(events, "serve.request")[0]
    parts = [annotations(events, k)[0] for k in SERVE_SPANS[1:]]
    assert all(inside(p, request) for p in parts)
    assert [p["ts"] for p in parts] == sorted(p["ts"] for p in parts)


@pytest.mark.parametrize("profiled", [False, True])
def test_the_exported_graph_holds_no_profiler_op(tmp_path, case, profiled):
    _, scene, _, _ = case
    if profiled:
        with profiling.trace(str(tmp_path)):
            blob = serving.export_render(scene, width=W, height=H)
    else:
        blob = serving.export_render(scene, width=W, height=H)
    graph = serving.load_render(blob)._program.graph
    targets = [str(n.target) for n in graph.nodes
               if n.op == "call_function"]
    assert any("raster_fwd_tap" in t for t in targets)
    assert not [t for t in targets if "profiler" in t]


# ------------------------------------- the bc1 and bc7 pools' shade

WH = 96
BC7 = ("shade.bc7", "bc7.texels")


def _world(pool_mode):
    """A small archive world on ``pool_mode`` → (case, view, palette)."""
    case = entry.world_case("cpu", buildings=8, width=W, height=WH,
                            characters=2, variants=3, terrain_subdiv=2,
                            building_subdivs=(1,), pool_mode=pool_mode)
    return case, case.view_proj(), case.bone_mats(6.0)


@pytest.fixture(scope="module")
def bc7_world():
    return _world("bc7")


@pytest.fixture(scope="module")
def bc1_world():
    return _world("bc1")


def _frames_open_the_pools_span(tmp_path, world, pool, capped):
    """Two frames: ``shade.<pool>`` twice, each inside its
    ``frame.shade``, and no other pool's; ``<pool>.texels`` the rows the
    shade ran (every tile, or at most the guard's tap cap) times their
    pixels times eight texels, twice."""
    case, vp, pal = world
    assert case.scene.pool_mode == pool
    taps = (td.auto_tap_tiles(case.batch, vp, pal, width=W, height=WH)
            if capped else None)
    pw, ph = td._padded(W, WH)
    rows = min(taps or pw * ph, pw * ph // td.SEG_PX)
    with profiling.trace(str(tmp_path)) as log_dir:
        for _ in range(2):
            td.render_frame(case.scene, vp, pal, width=W, height=WH,
                            packed=True, mipmap=True, tap_tiles=taps)
    spans = profiling.span_totals()
    assert spans[f"shade.{pool}"][0] == 2
    assert {n for n in spans if n.startswith("shade.")} == {f"shade.{pool}"}
    assert profiling.count_totals() == {
        f"{pool}.texels": 2 * rows * td.SEG_PX * td.TRILINEAR_TEXELS}
    events = trace_events(log_dir)
    shades = annotations(events, "frame.shade")
    opened = annotations(events, f"shade.{pool}")
    assert len(opened) == len(shades) == 2
    assert all(inside(b, s) for b, s in zip(opened, shades))


@pytest.mark.parametrize("capped", [False, True])
def test_a_bc7_frame_opens_its_shade_span_and_counts_its_texels(
        tmp_path, bc7_world, capped):
    _frames_open_the_pools_span(tmp_path, bc7_world, "bc7", capped)


@pytest.mark.parametrize("capped", [False, True])
def test_a_bc1_frame_opens_its_shade_span_and_counts_its_texels(
        tmp_path, bc1_world, capped):
    _frames_open_the_pools_span(tmp_path, bc1_world, "bc1", capped)


def _off_records_nothing(world):
    case, vp, pal = world
    td.render_frame(case.scene, vp, pal, width=W, height=WH, packed=True,
                    mipmap=True)
    assert profiling.span_totals() == {} and profiling.count_totals() == {}


def test_off_a_bc7_frame_records_neither(bc7_world):
    _off_records_nothing(bc7_world)


def test_off_a_bc1_frame_records_neither(bc1_world):
    _off_records_nothing(bc1_world)


def test_a_tri_world_frame_opens_no_shade_span(tmp_path):
    case, vp, pal = _world("tri")
    with profiling.trace(str(tmp_path)):
        td.render_frame(case.scene, vp, pal, width=W, height=WH,
                        packed=True, mipmap=True)
    assert set(profiling.span_totals()) == set(FRAME_SPANS)
    assert profiling.count_totals() == {}


def test_a_tri_frame_records_neither(tmp_path, case):
    batch, _, vp, bones = case
    scene = td.upload(batch, "tri", device="cpu")
    with profiling.trace(str(tmp_path)):
        td.render_frame(scene, vp, bones, width=W, height=H, mipmap=True)
    assert set(profiling.span_totals()) == set(FRAME_SPANS)
    assert profiling.count_totals() == {}


def test_a_count_adds_only_under_a_profiler(tmp_path):
    profiling.count("bc7.texels", 5)
    assert profiling.count_totals() == {}
    profiling._COUNTS["stale"] = 3
    with profiling.trace(str(tmp_path)):
        profiling.count("bc7.texels", 5)
        profiling.count("bc7.texels", 7)
    assert profiling.count_totals() == {"bc7.texels": 12}  # reset on entry
    profiling.reset_spans()
    assert profiling.count_totals() == {}


@pytest.mark.parametrize("profiled", [False, True])
def test_a_recording_takes_the_counts_profiler_or_not(tmp_path, profiled):
    """Inside ``recording()`` every count goes to the recording's table
    and none to the counter table, with or without a profiler (a CUDA
    graph's capture); the recordings nest, and outside them counting is
    as before."""
    def counted():
        with profiling.recording() as outer:
            profiling.count("bc7.kernel_taps", 4)
            with profiling.recording() as inner:
                profiling.count("bc7.kernel_taps", 2)
            profiling.count("bc7.texels", 3)
        profiling.count("bc7.texels", 1)
        return outer, inner

    if profiled:
        with profiling.trace(str(tmp_path)):
            outer, inner = counted()
    else:
        outer, inner = counted()
    assert outer == {"bc7.kernel_taps": 4, "bc7.texels": 3}
    assert inner == {"bc7.kernel_taps": 2}
    assert profiling.count_totals() == ({"bc7.texels": 1} if profiled
                                        else {})
