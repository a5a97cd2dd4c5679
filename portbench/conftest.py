"""pytest settings of the benchmark's tests (`python -m pytest portbench/tests`).

Tests that need a CUDA card carry the `card` marker and take the `card`
fixture, which skips them where torch sees no card; they run on the card
with the same command."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return "cuda"
