"""``bc7_kernel_share`` reads a planted counter table: eight kernel taps
a decoded texel's worth, and nothing where either counter is missing."""

import pytest

from portbench import bench

CELL = "world_bc7.orbit"


@pytest.mark.parametrize("counts,want", [
    ({"bc7.kernel_taps": 2_088_960, "bc7.texels": 16_711_680}, 1.0),
    ({"bc7.kernel_taps": 1_044_480, "bc7.texels": 16_711_680}, 0.5),
    ({"bc7.texels": 16_711_680}, None),
    ({"bc7.kernel_taps": 2_088_960}, None),
    ({}, None),
])
def test_the_share_reads_the_planted_counters(monkeypatch, counts, want):
    from mt_renderer_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "count_totals", lambda: dict(counts))
    assert bench.Bench().reader("bc7_kernel_share")({}) == want


def test_the_share_is_the_bc7_cells_alone():
    b = bench.Bench()
    spec = {m["name"]: m for m in b.spec["per_layer"]}["bc7_kernel_share"]
    assert spec["workloads"] == [CELL] and spec["moves"] == "frame_ms"
    assert spec["layer"] == {m["name"]: m for m in b.spec["per_layer"]}[
        "bc7_texels"]["layer"]
