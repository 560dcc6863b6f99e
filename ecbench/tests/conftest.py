import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skipped without CUDA (the "
        "`card` fixture decides)")


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda", 0)


@pytest.fixture
def no_card() -> None:
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path is not taken")
