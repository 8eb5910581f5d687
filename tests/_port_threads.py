"""One PyTorch CPU thread for the port's heavier test files.

The tiny fixture model's tensor operations are too small to split across
threads. Under pytest-xdist every worker otherwise keeps a full set of
OpenMP threads spinning, and the workers slow each other down many times
over (a CLI test of 15 s alone took 13 minutes in a six-worker run). A test
file imports the fixture to run its tests single-threaded; the count is
restored after the file's last test."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
