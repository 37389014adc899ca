"""Tests of the benchmark itself.  ``card`` marks the tests that run on
a GPU; they ask for the ``cuda_device`` fixture, which decides at run
time whether a card is present and skips with the reason when not."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
