"""The benchmark's own tests: CPU checks of the harness, and tests marked
``cuda`` that need the card (they skip without one)."""

import pytest


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
