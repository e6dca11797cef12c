"""The benchmark's own tests. CPU tests run anywhere; those marked `cuda`
need an NVIDIA card and skip without one:

    python -m pytest benchmark/tests -q              # here
    python -m pytest -m cuda benchmark/tests -q      # on the card
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def cuda_card():
    """Skips the test where no CUDA card is present (decided here, when
    the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
