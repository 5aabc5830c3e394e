"""The comparison that decides ``correct``, on the CPU at small sizes
through the port's plain K1 path: the program agrees with the plain
reference; the control (the reference in bfloat16 in the program's
place) and each fault a cell can have, planted under the timed path,
come out not correct."""

import time

import pytest

from portbench import bench, faults

from .small import small

CELLS = ["headline.orbit", "headline.served", "world.orbit", "world.served"]


def _run(workload, seed=2**31 + 5, control=False):
    return bench.run_cell(workload, seed, 0.3, False,
                          t_start=time.perf_counter(), device="cpu",
                          overrides=small(workload), control=control)


@pytest.mark.parametrize("workload", CELLS)
def test_program_agrees_and_the_control_does_not(workload):
    out = _run(workload, control=True)
    assert out["correct"] is True, out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name
    assert out["control"]["correct"] is False, out["control"]


@pytest.mark.parametrize("fault", faults.FRAME)
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_path_is_not_correct(monkeypatch, workload, fault):
    faults.plant(monkeypatch.setattr, workload, fault)
    out = _run(workload, seed=2**31 + 11)
    assert out["correct"] is False, (fault, out["checks"])


@pytest.mark.parametrize("fault", faults.SHADE)
@pytest.mark.parametrize("workload", ["world.orbit", "world.served"])
def test_a_shade_fault_fails_the_colour_number(monkeypatch, workload, fault):
    """A trilinear tap one level off, or with no blend between levels,
    fails ``color_off`` at the world cells' own limits: the colour is
    judged against every surface the depth test may rightly pick, so its
    floor is rounding, not the far field's depth order."""
    faults.plant(monkeypatch.setattr, workload, fault)
    out = _run(workload, seed=2**31 + 11)
    assert out["correct"] is False, (fault, out["checks"])
    c = out["checks"]["color_off"]
    assert c["value"] > c["limit"], (fault, out["checks"])
