"""The benchmark's tests: CPU tests at the port's smoke sizes, and tests
marked ``chip`` that need a CUDA card and skip without one."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one); run on the "
        "card with python -m pytest -m chip hopaas_bench")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
