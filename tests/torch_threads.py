"""The one intra-op thread every port test module runs on.

Each ``tests/test_torch_*.py`` takes the fixture by importing it in one
line, ``from torch_threads import one_thread  # noqa: F401``; an
autouse fixture in a module's namespace applies to that module's tests
only, so the JAX package's tests keep torch's default.
``test_torch_threads.py`` fails when a port test module does not take
it, or sets the thread count on its own. A subprocess that a port test
starts gets ``OMP_NUM_THREADS=1`` in its environment instead.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small tensor ops, which
    slow down by an order of magnitude when the parallel test workers'
    threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
