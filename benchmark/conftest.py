"""The benchmark's own tests (`python -m pytest benchmark/tests`): CPU tests
at small sizes, and tests marked `card` that run only where a CUDA device
is present (decided inside the `card` fixture, never at import)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skipped on a machine without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark's cells run on the card)")
    return torch.device("cuda", 0)
