"""Tests of the port's benchmark. Run from the repository's root:

    python -m pytest -q -p no:cacheprovider portbench/tests

Tests marked ``card`` need an NVIDIA card and skip without one; they decide
inside a fixture, never while this module or a test module is imported.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (the benchmark's readings on the card)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the control's readings are taken on the card")
    return "cuda"
