"""The port's profiling tools on the CPU: ``utils.profiling.trace`` and
``stage_timer``.

``trace`` around a frame writes a Chrome trace that names K1's op
(``mtr::raster_fwd_tap``) with a duration; ``stage_timer`` accumulates
seconds under each stage's name, fences what it is given (a CUDA tensor
synchronises its device; CPU tensors need nothing) and marks the stage
as a ``record_function`` range that a trace shows under its name. The
card's half (K1's ``__global__`` kernel in the trace) runs in
``chip_smoke.py`` (s3)."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr
from mt_renderer_tpu_torch.scene import demo
from mt_renderer_tpu_torch.utils import profiling

W, H = 128, 64


@pytest.fixture(scope="module")
def case():
    batch = demo.build_demo_batch(instances=4, skinned=True, subdiv=1)
    return (td.upload(batch, device="cpu"),
            np.asarray(demo.demo_camera(4, W, H).view_proj()),
            demo.demo_bone_mats(0.4))


def trace_events(log_dir) -> list:
    path = Path(log_dir) / profiling.TRACE_FILE
    return json.loads(path.read_text())["traceEvents"]


@pytest.mark.parametrize("mipmap", [False, True])
def test_trace_names_the_k1_op(tmp_path, case, mipmap):
    scene, vp, bones = case
    if mipmap:
        scene = td.upload(demo.build_demo_batch(instances=4, skinned=True,
                                                subdiv=1), "tri",
                          device="cpu")
    with profiling.trace(str(tmp_path / "tr")) as log_dir:
        td.render_frame(scene, vp, bones, width=W, height=H, mipmap=mipmap)
    assert log_dir == str(tmp_path / "tr")
    op = "mtr::raster_fwd_mtap" if mipmap else "mtr::raster_fwd_tap"
    events = [e for e in trace_events(log_dir) if e.get("name") == op]
    assert len(events) == 1 and events[0]["dur"] > 0
    tr.flush_overflow_checks()


def test_trace_defaults_to_the_temporary_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(profiling.tempfile, "tempdir", None)
    with profiling.trace() as log_dir:
        torch.ones(4).sum()
    assert log_dir == str(tmp_path / "mtr_trace")
    assert trace_events(log_dir)


def test_stage_timer_accumulates_and_marks_its_range(tmp_path, case):
    scene, vp, bones = case
    times = {}
    with profiling.trace(str(tmp_path)) as log_dir:
        for _ in range(2):
            with profiling.stage_timer(times, "vertex") as fence:
                clip = fence(td.vertex_stage(scene, vp, bones))
            with profiling.stage_timer(times, "setup") as fence:
                fence(td.setup_packed_cols(scene, clip, W, H))
    assert set(times) == {"vertex", "setup"}
    assert all(t > 0.0 for t in times.values())
    names = [e.get("name") for e in trace_events(log_dir)]
    assert names.count("vertex") == 2 and names.count("setup") == 2
    before = dict(times)
    with profiling.stage_timer(times, "vertex") as fence:
        time.sleep(0.01)
    assert times["vertex"] >= before["vertex"] + 0.01


def test_stage_timer_fences_the_devices_of_what_it_is_given(monkeypatch):
    """Every CUDA device among the fenced tensors (nested in tuples,
    lists and dicts) is synchronised once before the clock stops; CPU
    tensors synchronise nothing."""
    nested = (torch.ones(2), [torch.zeros(3)], {"a": torch.ones(1), "b": 4})
    assert len(list(profiling._tensors([nested]))) == 3
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    times = {}
    with profiling.stage_timer(times, "cpu") as fence:
        assert fence(nested) is nested
    assert synced == [] and "cpu" in times
    monkeypatch.setattr(profiling, "_tensors",
                        lambda fenced: iter([_Card(0), _Card(1), _Card(0)]))
    with profiling.stage_timer(times, "cuda") as fence:
        fence(nested)
    assert sorted(str(d) for d in synced) == ["cuda:0", "cuda:1"]


class _Card:
    """Stands in for a tensor on CUDA device ``index``."""

    def __init__(self, index: int):
        self.device = torch.device("cuda", index)
