"""Shared fixtures. NOTE: no XLA_FLAGS here — tests run on the 1 real CPU
device (the 512-device setting is exclusively the dry-run entry point)."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "hyp: property-based tests (need the optional hypothesis dep; "
        "run with -m hyp, excluded from tier-1 via -m 'not hyp')")
    config.addinivalue_line(
        "markers", "slow: long-running tests, excluded from quick loops")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (the port's CUDA kernels); skips "
        "without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
