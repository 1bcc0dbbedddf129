"""Tests of the benchmark harness. Run them with

    python -m pytest benchmark/tests -q

Tests marked `card` need a CUDA device and skip without one (each decides
inside a fixture, never at import)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (run on the card)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
