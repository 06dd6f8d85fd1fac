"""Shared fixtures.  NOTE: no XLA device-count flags here — tests run on the
single CPU device; only launch/dryrun.py forces 512 placeholder devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recompile_guard import recompile_budget  # noqa: F401  (fixture export)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    # The full suite compiles hundreds of distinct XLA executables in one
    # process; on single-core CPU boxes the accumulated compiler/JIT state
    # eventually segfaults inside backend_compile (observed deterministically
    # around test 155 of 291).  Dropping the jit caches at module boundaries
    # bounds that growth; cross-module cache hits are rare (different shapes)
    # so the recompile cost is negligible.
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def random_weight(rng, shape, scale=1.0):
    return jnp.asarray(rng.normal(size=shape).astype(np.float32) * scale)


@pytest.fixture
def small_batch(rng):
    return {"tokens": jnp.asarray(rng.integers(0, 512, (2, 32)))}
