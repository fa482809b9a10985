"""The benchmark's own tests: they run on the CPU; those marked ``cuda``
need a card and skip without one (the ``card`` fixture decides)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs NVIDIA GPUs; skipped without them")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)
