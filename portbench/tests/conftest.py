"""The benchmark's own tests: ``python -m pytest portbench/tests -q``.

Tests that need an NVIDIA card carry the ``cuda`` marker (registered
here, as the repository's own settings register it for ``tests/``) and
decide inside a fixture whether to skip."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where "
        "torch.cuda.is_available() is False")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")
