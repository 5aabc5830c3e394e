"""The harness's tests: on the CPU at small sizes, through the port's
plain K1 path; those marked ``gpu`` need a CUDA device and skip without
one (decided in the ``cuda`` fixture, never at import)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (a hand-written kernel of "
        "mt_renderer_tpu_torch); skips without one")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="session")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
