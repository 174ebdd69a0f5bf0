"""Thread limits for the port's heavier CPU tests.

The suite runs in several worker processes on one host; PyTorch and numpy's
BLAS start as many threads as the host has cores in each of them, and tests
of many small products then spend most of their time contending for the
cores. Importing ``one_torch_thread`` into a test module runs each of its
tests with one PyTorch thread (restored afterwards), and ``single_thread_env``
gives a subprocess the same limit.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def single_thread_env(**extra) -> dict:
    """The environment for a subprocess with one thread for PyTorch, the BLAS
    libraries and XLA's CPU client."""
    flags = os.environ.get("XLA_FLAGS", "")
    return dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
                XLA_FLAGS=f"{flags} --xla_cpu_multi_thread_eigen=false".strip(), **extra)
