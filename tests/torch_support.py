"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py)."""

import pytest
import torch

# Intra-op threads of the CPU tests. With more than one, PyTorch's CPU exp (torch 2.13,
# MKL build) computes the calling thread's share of its first parallel call in a process
# with a less accurate method in about one process in fifteen: up to ~800 ulp, 1.5e-4
# relative, on half the elements. One thread never does (0 of 80 processes). Every test
# module sets the same count: each pytest-xdist worker imports all of them, and the last
# import's count is the one the worker runs with.
CPU_THREADS = 1


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test when there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU interpret mode")
    return torch.device("cuda", 0)
