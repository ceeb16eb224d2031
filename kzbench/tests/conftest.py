"""The benchmark's CPU tests: ``python -m pytest kzbench/tests``. Torch
keeps to a few threads; tests marked ``cuda`` skip without a card."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
torch.set_num_threads(min(4, torch.get_num_threads()))


@pytest.fixture
def tiny():
    """(config, traffic) overrides: a cell at a size a test run holds, 16x12
    pixels and two passes a call, every pixel checked."""
    return {"width": 16, "height": 12, "spp": 2}, {"check_pixels": 16 * 12}


@pytest.fixture
def card():
    """Skips the test without a CUDA device (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; this machine has none")
    return torch.device("cuda")
