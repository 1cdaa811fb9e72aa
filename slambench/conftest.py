"""Test settings of the benchmark's own tests (run from the repository root:
`python -m pytest slambench -q`; on the card: `python -m pytest slambench -q -m card`).

Tests marked `card` need a CUDA device and skip without one; the decision
is taken inside the `card` fixture, never at import.
"""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
