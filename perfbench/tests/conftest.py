"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
repository's root, on the CPU; those marked ``cuda`` skip there and run on
a card with ``-m cuda``. They import no JAX."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
