"""``serve_graph_share`` reads planted counter and span tables: the
replayed requests over the served requests, and nothing where the
counter or the requests are missing."""

import pytest

from portbench import bench

CELLS = ["headline.served", "world.served"]


@pytest.mark.parametrize("counts,requests,want", [
    ({"serve.replays": 240}, 240, 1.0),
    ({"serve.replays": 180}, 240, 0.75),
    ({"serve.replays": 0}, 240, 0.0),
    ({}, 240, None),
    ({"serve.replays": 240}, 0, None),
])
def test_the_share_reads_the_planted_tables(monkeypatch, counts, requests,
                                            want):
    from mt_renderer_tpu_torch.utils import profiling

    spans = {"serve.request": (requests, 1.0)} if requests else {}
    monkeypatch.setattr(profiling, "count_totals", lambda: dict(counts))
    monkeypatch.setattr(profiling, "span_totals", lambda: dict(spans))
    assert bench.Bench().reader("serve_graph_share")({}) == want


def test_the_share_is_the_served_cells_alone():
    b = bench.Bench()
    layers = {m["name"]: m for m in b.spec["per_layer"]}
    spec = layers["serve_graph_share"]
    assert spec["workloads"] == CELLS and spec["moves"] == "request_ms"
    assert spec["source"] == "program_counter"
    assert spec["layer"] == layers["launches.served"]["layer"]
