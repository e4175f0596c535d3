"""Tests of the benchmark harness. They run on the CPU at the program's
`tiny` sizes; those marked `card` drive the harness on a CUDA card and
skip without one (decided inside the test, never at import)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped here without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures on the card only")
    return torch.device("cuda:0")


@pytest.fixture
def layout(tmp_path):
    from vobench.tests.tiny import write_layout

    return write_layout(tmp_path)


@pytest.fixture
def card_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal without one is not reachable here")
