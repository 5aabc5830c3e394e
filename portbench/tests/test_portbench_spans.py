"""The readers of the program's spans (``portbench/spans.py`` and the
metrics on it): None from an empty table, from a program without one and
from a table that holds more than the window's frames, ms per frame from
a planted table, and a traced run on the CPU that reports the guard's
parts within the benchmark's own ``guard_ms``."""

import time

import pytest

from mt_renderer_tpu_torch.utils import profiling
from portbench import bench, spans

from .small import small

GUARD_PARTS = ("guard_skin_ms", "guard_project_ms", "guard_tiles_ms")
SPAN_READERS = GUARD_PARTS + ("guard_palette_ms",)


def ctx(items: int = 4) -> dict:
    return dict(trace=dict(items=items))


@pytest.fixture
def planted(monkeypatch):
    table = {"engine.guard": [4, 700_000_000],
             "predict.skin": [8, 400_000_000],
             "predict.project": [8, 200_000_000],
             "predict.bins": [4, 12_000_000],
             "predict.rows": [4, 8_000_000]}
    monkeypatch.setattr(profiling, "_TOTALS", table)
    return table


def test_an_empty_table_reads_none(monkeypatch):
    monkeypatch.setattr(profiling, "_TOTALS", {})
    b = bench.Bench()
    assert spans.ms_per_frame(ctx(), "predict.skin") is None
    for name in SPAN_READERS:
        assert b.reader(name)(ctx()) is None, name


def test_a_program_without_the_table_reads_none(monkeypatch, planted):
    monkeypatch.delattr(profiling, "span_totals")
    assert spans.totals() == {}
    assert spans.ms_per_frame(ctx(), "predict.skin") is None


def test_ms_per_frame_from_a_planted_table(planted):
    b = bench.Bench()
    assert spans.ms_per_frame(ctx(), "predict.skin") == pytest.approx(100.0)
    assert spans.ms_per_frame(ctx(0), "predict.skin") is None
    assert b.reader("guard_skin_ms")(ctx()) == pytest.approx(100.0)
    assert b.reader("guard_project_ms")(ctx()) == pytest.approx(50.0)
    assert b.reader("guard_tiles_ms")(ctx()) == pytest.approx(5.0)
    assert b.reader("guard_palette_ms")(ctx()) is None


@pytest.mark.parametrize("guards", [0, 3, 8])
def test_a_table_of_another_stretch_reads_none(planted, guards):
    """An earlier profiled stretch in the process (``guards`` 8 over a
    4-frame window), a stretch cut short (3) or a program that never
    guarded (0): no reading rather than another run's number."""
    planted["engine.guard"][0] = guards
    b = bench.Bench()
    for name in SPAN_READERS:
        assert b.reader(name)(ctx()) is None, name


def test_a_traced_orbit_run_reads_the_guard_parts():
    profiling.reset_spans()
    out = bench.run_cell("headline.orbit", 2**31 + 29, 0.5, True,
                         t_start=time.perf_counter(), device="cpu",
                         overrides=small("headline.orbit"))
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"] is True
    assert "guard_palette_ms" not in m        # the headline's palette is NumPy
    assert profiling.span_totals()["engine.guard"][0] == out["attempted"]
    parts = sum(m[k] for k in GUARD_PARTS)
    assert 0.0 < parts <= m["guard_ms"]
