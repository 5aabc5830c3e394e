"""The cells ``world_bc1.orbit`` and ``world_bc7.served`` at the world's
small sizes on the CPU: the BC1 world (``configs/world_bc1.json``,
``scenes/world_bc1.py``) is the world with BC1 textures and nothing
else; both cells are correct and their controls are not; reading a
three-colour BC1 block as four-colour fails the orbit cell's colour
number; the two BC1 metrics read a traced run, equal the BC7 world's
texel count on the same seed, and read nothing on the tri world; and
each cell reports exactly its end-to-end and per-layer metrics."""

import json
import time

import numpy as np
import pytest

from portbench import bench, faults
from portbench.scenes import builder

from .small import small

BC1 = "world_bc1.orbit"
SERVED = "world_bc7.served"
METRICS = ("bc1_shade_ms", "bc1_texels")


def _run(cell, seed, traced=False, control=False):
    return bench.run_cell(cell, seed, 0.3, traced,
                          t_start=time.perf_counter(), device="cpu",
                          overrides=small("world"), control=control)


def test_the_configuration_is_the_world_with_bc1_textures():
    b = bench.Bench()
    world, bc1 = b.config("world"), b.config("world_bc1")
    changed = {k for k in set(world) | set(bc1)
               if world.get(k) != bc1.get(k)}
    assert changed == {"name", "source", "builder", "pool",
                       "texture_format", "assumed"}
    assert bc1["pool"] == bc1["texture_format"] == "bc1"
    assert bc1["builder"] == "world_bc1"
    # the world's assumptions kept, the textures' restated, two added
    assert set(bc1["assumed"]) == set(world["assumed"]) | {"bc1_blocks",
                                                           "pool"}
    kept = set(world["assumed"]) - {"textures", "texture_noise"}
    assert all(bc1["assumed"][k] == world["assumed"][k] for k in kept)
    entry = next(c for c in b.spec["configs"] if c["name"] == "world_bc1")
    assert entry["reduced"] == [] and entry["source"] == bc1["source"]
    assert entry["file"] == "portbench/configs/world_bc1.json"
    arrays = builder(bc1["builder"]).build(dict(bc1, **small("world")),
                                           2**31 + 109)
    assert arrays.chain_format == "bc1"
    assert len(arrays.chains) == len(arrays.textures)
    blocks = np.concatenate([lvl[0] for c in arrays.chains for lvl in c])
    assert blocks.shape[1] == 8
    c0 = blocks[:, 0] | (blocks[:, 1].astype(np.int64) << 8)
    c1 = blocks[:, 2] | (blocks[:, 3].astype(np.int64) << 8)
    assert 0.4 < (c0 <= c1).mean() < 0.6          # three-colour blocks
    # the textures are the chains' level 0, transparent texels among them
    assert any((t[..., 3] == 0).any() for t in arrays.textures)


@pytest.mark.parametrize("cell", [BC1, SERVED])
def test_the_program_is_correct_and_the_control_is_not(cell):
    out = _run(cell, 2**31 + 113, control=True)
    assert out["correct"] is True, out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name
    assert out["control"]["correct"] is False, out["control"]


def test_reading_three_colour_blocks_as_four_fails_the_colour_number(
        monkeypatch):
    faults.plant(monkeypatch.setattr, BC1, "bc1_four_color")
    out = _run(BC1, 2**31 + 127)
    assert out["correct"] is False, out["checks"]
    c = out["checks"]["color_off"]
    assert c["value"] > c["limit"], out["checks"]


def _traced_metrics(cell, seed):
    from mt_renderer_tpu_torch.utils import profiling

    profiling.reset_spans()
    out = _run(cell, seed, traced=True)
    assert out["correct"] is True, out["checks"]
    b = bench.Bench()
    after = {name: b.reader(name)({}) for name in METRICS}
    profiling.reset_spans()
    return out["metrics"], after


def test_the_bc1_metrics_read_a_traced_run_as_the_bc7_world_counts():
    seed = 2**31 + 131
    got, _ = _traced_metrics(BC1, seed)
    assert got["bc1_shade_ms"]["value"] > 0.0
    assert got["bc1_shade_ms"]["unit"] == "ms"
    texels = got["bc1_texels"]["value"]
    assert got["bc1_texels"]["unit"] == "texels/frame"
    # the shaded rows are whole 2048-pixel tiles, eight texels a pixel
    assert texels > 0 and texels % (2048 * 8) == 0
    # the same geometry on the bc7 pool decodes as many texels a shade
    bc7, _ = _traced_metrics("world_bc7.orbit", seed)
    assert bc7["bc7_texels"]["value"] == texels


def test_the_bc1_metrics_are_absent_on_the_tri_world():
    got, after = _traced_metrics("world.orbit", 2**31 + 137)
    assert not set(METRICS) & set(got)
    assert after == dict.fromkeys(METRICS)
    spec = {m["name"]: m for m in bench.Bench().spec["per_layer"]}
    for name in METRICS:
        assert spec[name]["workloads"] == [BC1]
        assert spec[name]["layer"] == "shade: BC1 decode"
        assert spec[name]["moves"] == "frame_ms"


@pytest.mark.parametrize("cell, e2e, layers", [
    (BC1, {"frame_ms", "frame_p95_ms", "setup_s"},
     {"guard_ms", "device_busy_ms.frame", "idle_share.frame",
      "k1_roofline.frame", "bc1_shade_ms", "bc1_texels"}),
    (SERVED, {"request_ms", "setup_s"},
     {"idle_share.served", "launches.served", "k1_roofline.served",
      "traced_p95_ms.served", "serve_graph_share"})])
def test_the_cell_reports_its_metrics(cell, e2e, layers):
    b = bench.Bench()
    w = b.workload(cell)
    assert w["chips"] == 1
    assert (w["config"], w["traffic"]) == tuple(cell.split("."))
    assert {m["name"] for m in b.end_to_end(cell)} == e2e
    assert {m["name"] for m in b.per_layer(cell)} == layers
    lim = json.loads((b.root / "limits" / f"{cell}.json").read_text())
    assert set(lim) == {"coverage_mismatch", "color_off",
                        "depth_gap_median"}
