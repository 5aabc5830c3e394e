"""The port's profiling trace on the CPU: ``utils.profiling.trace``
around a frame writes a Chrome trace that names K1's op
(``mtr::raster_fwd_tap``) with a duration. The spans are
``test_torch_spans.py``'s; the card's half (K1's ``__global__`` kernel
in the trace, inside ``frame.raster``) runs in ``chip_smoke.py`` (s3)."""

import json
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
