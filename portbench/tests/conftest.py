"""The benchmark's own tests. Most run on the CPU at tiny sizes; those
marked ``card`` need an NVIDIA GPU and skip here (whether a card is present
is decided inside the ``cuda`` fixture, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (run on the chip)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the chip")
    return torch.device("cuda")
