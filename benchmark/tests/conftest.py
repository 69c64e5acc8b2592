"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``card`` that run only where a CUDA device is present (they skip here, from
a fixture, never at import)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest benchmark/tests -m card)")
    return torch.device("cuda", 0)
