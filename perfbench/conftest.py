"""pytest settings of the benchmark's own tests: the repository root on the
path, and the `card` marker with its fixture. A test marked `card` needs a
CUDA device; the `card` fixture decides at run time, and skips with its
reason where there is none."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips on the CPU)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs the cell's sizes on the card")
    return torch.device("cuda")
