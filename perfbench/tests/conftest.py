"""Shared fixtures of the benchmark's own tests (run from the repo root:
``python -m pytest perfbench/tests -q``)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "BENCHMARK.json"


@pytest.fixture
def bench():
    return BENCH


@pytest.fixture
def card():
    """The card, or a skip: decided here, when a test asks, never at
    import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda:0")
