"""pytest settings of the benchmark's own tests (``portbench/tests``):
the ``card`` marker, whose tests need a CUDA device and skip without one."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (the H100); skips without one")


@pytest.fixture
def card():
    """Skip the test on a machine without a CUDA device; decided when the
    test runs, never while a module is imported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a card test runs on the H100 only")
    return torch.device("cuda", 0)
