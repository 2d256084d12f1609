"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches
must see 1 CPU device; only launch/dryrun.py forces 512."""
import jax
import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where there is none")
