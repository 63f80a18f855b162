"""Test harness config: run on a virtual 8-device CPU mesh.

The reference has no tests (SURVEY §4); this suite formalizes its bag-replay
validation as simulator-replay + golden/unit tests. Multi-chip sharding is
validated on 8 virtual CPU devices via xla_force_host_platform_device_count —
the local-multiprocess analogue of a multi-host run.
"""

import os

# The tests run on the CPU, on a virtual 8-device mesh. Only tests marked
# ``gpu`` need a card; on the GPU machine run them with
#   JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX has none. Decided here, at
    run time, so every xdist worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    return dev
