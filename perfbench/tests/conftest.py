"""The card/no-card decision for the benchmark's tests, made in a fixture."""

import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels of amcx_torch run only there")
    return torch.device("cuda", 0)
