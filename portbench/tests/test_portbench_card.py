"""On the card, at each cell's own size: the program comes out correct
and the control (the reference in bfloat16 in the program's place) does
not. The readings that set the limits come from
``python3 -m portbench.calibrate`` over a dozen seeds; this test checks
one seed a cell."""

import time

import pytest

from portbench import bench

CELLS = ["headline.orbit", "headline.served", "world.orbit", "world.served"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(cuda, workload):
    out = bench.run_cell(workload, 2**31 + 3, 3.0, False,
                         t_start=time.perf_counter(), device=cuda,
                         control=True)
    assert out["device"]["platform"] == "gpu"
    assert out["correct"] is True, out["checks"]
    assert out["control"]["correct"] is False, out["control"]
