"""CPU tests of the benchmark; ``card`` tests need a CUDA card and skip
without one. Run from the repo root: ``python3 -m pytest portbench/tests``."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny():
    """``tiny(name)``: cell ``name`` cut to a CPU test's size (the same
    files, smaller images, fewer iterations and samples)."""
    from portbench import run

    def make(name, size=32, sample=2):
        cell = copy.deepcopy(run.load_cell(name))
        cell.mix.update(batch=min(cell.mix["batch"], 2), size=size, pool=2)
        for key in ("batch", "size"):
            cell.config.pop(key, None)
        if "maxit" in cell.workload["args"]:
            cell.workload["args"]["maxit"] = 20
        cell.workload.update(sample=sample, warmup=1, trace_requests=2)
        return cell

    return make
