"""Fixtures of the benchmark's own tests."""

import pytest
import torch


@pytest.fixture
def cuda_card():
    """The card, for the tests marked ``cuda``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    return torch.device('cuda')
