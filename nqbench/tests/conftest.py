"""The benchmark's own tests (``python -m pytest nqbench/tests``). Tests
that need the card carry the ``card`` marker and skip inside the ``card``
fixture where there is none."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs only there")
    return torch.device("cuda")
