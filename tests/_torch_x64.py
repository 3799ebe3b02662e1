"""The `x64` fixture of the port's parity tests: JAX float64 for one test,
restoring the setting it found.

It overrides the session fixture of tests/conftest.py, which switches
float64 on once for the whole session.  Reference modules that switch it
off at their end (tests/test_pcg.py, tests/test_resilience.py) would
otherwise leave it off for every later test on that worker that asks for
the session fixture — tests/test_geometry.py's too, when a port module
asked for the fixture first.  Import it into a test module:
``from _torch_x64 import x64  # noqa: F401``.
"""

import jax
import pytest


@pytest.fixture
def x64():
    saved = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", saved)
