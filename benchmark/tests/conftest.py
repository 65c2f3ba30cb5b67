"""Tests of the benchmark harness.  They run on the host at tiny sizes;
a test marked ``gpu`` needs a CUDA card and skips without one (decided
in the ``cuda_device`` fixture, never at import)."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the benchmark on the card)")


@pytest.fixture(autouse=True)
def two_threads():
    """Host runs on two threads, for these tests alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark's kernels have no "
                    "CPU mode")
    return "cuda"
