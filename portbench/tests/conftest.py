"""CPU tests of the benchmark harness: `python -m pytest portbench/tests`
from the root of the repository.  Tests marked `cuda` run only where a
card is present and skip elsewhere."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped where "
        "torch.cuda.is_available() is false")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
