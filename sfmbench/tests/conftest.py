"""The benchmark's own tests. Run them from the repository's root:

    python -m pytest sfmbench/tests -q

Tests marked `cuda` need the card and skip without one; they decide in the
`cuda_device` fixture, never while a module is imported."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return "cuda"
