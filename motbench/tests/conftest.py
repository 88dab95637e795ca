"""The benchmark's own tests: run from the repository root with
``python -m pytest motbench/tests``. Tests that need the card carry the
``cuda`` marker and decide inside a fixture whether there is one."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's hand kernels)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')
