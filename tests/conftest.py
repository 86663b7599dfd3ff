"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-chip sharding is tested on host devices
(xla_force_host_platform_device_count), per the project test strategy —
the driver separately dry-runs the multi-chip path via __graft_entry__.py.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Tests run on host CPU devices (deterministic f64, 8 virtual devices for
# mesh tests) even where an accelerator is attached; the config update
# wins over a platform chosen elsewhere in the environment.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)
