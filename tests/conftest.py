"""Test harness config: run on a virtual 8-device CPU mesh.

JAX reads these settings when its first backend initializes, so they are
set before anything imports a JAX-touching module.  A ``JAX_PLATFORMS``
already in the environment wins: the card-only tests run with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist``.
"""

import os

if not os.environ.get("JAX_PLATFORMS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0xB15EA7)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    The full suite compiles hundreds of distinct XLA:CPU programs in one
    process; with all of them held live, a later compile has segfaulted
    inside ``backend_compile_and_load``.  Clearing the cache between
    modules keeps the accumulated JIT state bounded; cross-module cache
    reuse is ~nil anyway (each module uses its own shapes)."""
    yield
    jax.clear_caches()
