"""The benchmark's tests: the reference, the harness and the control on
the CPU, at small sizes; tests marked ``card`` run on a CUDA card only."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where none is visible")


@pytest.fixture
def card():
    """torch, where a CUDA card is visible; skips the test elsewhere."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible; this test runs on the card")
    return torch
