"""Tests of the benchmark folder. They run on the CPU; those marked ``card``
need a CUDA card and skip without one (decided in the fixture, never at
import). Run them with ``python -m pytest port_bench/tests -q`` from the
repo root; on the card, ``-m card`` runs the card's alone."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DATA = Path(__file__).resolve().parent / "data"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the cell at its own size on the card")
    return torch.device("cuda")


@pytest.fixture
def tiny_cell():
    """A loader of the tiny test cells under data/, on the CPU."""
    from port_bench import spec

    def load(name):
        return spec.load_cell(name, DATA)

    return load
