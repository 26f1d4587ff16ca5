"""pytest settings of the benchmark's own tests (``bench/tests``).

The tests import the benchmark as the package ``bench`` and the program
from ``src``.  Tests that need a CUDA card carry the ``cuda`` marker and
ask for the ``cuda_card`` fixture, which decides while the test runs, never
while modules are imported, and skips where there is no card."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is absent")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


TINY = {"lubm1.replay": {"clients": 4, "pool": 8, "deck": 64,
                         "per_second": 400, "sample": 32},
        "lubm1.fresh": {"warmup": 4, "deck": 64, "per_second": 200,
                        "sample": 16}}
TINY_DEPARTMENTS = (2, 2)


@pytest.fixture
def tiny_uba(monkeypatch):
    """UBA's universities cut to two departments: data a test holds."""
    from bench.gen import uba
    monkeypatch.setattr(uba, "DEPARTMENTS", TINY_DEPARTMENTS)
    return uba


@pytest.fixture
def tiny_cell(tiny_uba):
    """``tiny_cell(name)``: the cell of BENCHMARK.json at a size a test
    holds, its university cut to two departments and its mix in clients,
    pool and sample."""
    from bench.harness import load_cell

    def make(name):
        cell = load_cell(ROOT, name)
        cell.mix.update(TINY[name])
        return cell

    return make
