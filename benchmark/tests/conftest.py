"""The benchmark's own tests: run from the repository's root with
`python -m pytest benchmark/tests -q`. The tests marked `gpu` need the
card and skip without one (decided inside the `cuda` fixture)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels have no CPU mode")
    return torch.device("cuda", 0)
