"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see 1 CPU device;
multi-device tests spawn subprocesses (see tests/test_distributed.py)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest

try:  # property tests prefer real hypothesis; fall back to the vendored shim
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _hypothesis_fallback

    _hypothesis_fallback.install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture(scope="session")
def x64():
    """Enable fp64 for reference-precision core tests."""
    import jax
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)
