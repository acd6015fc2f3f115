"""Pytest settings of the benchmark's tests: the marker of tests that
need a GPU, as the repository's ``tests/`` registers it."""
import sys
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[2] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with nvcc (the port's CUDA kernels); "
        "skipped where torch.cuda.is_available() is False")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return "cuda"


@pytest.fixture(autouse=True)
def few_threads():
    """One intra-op thread: the suite runs several workers at once."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
