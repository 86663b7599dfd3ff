"""GPU test tier: device checks of the solve paths on an NVIDIA GPU.

Unlike tests/conftest.py this does not force the CPU. Every test carries
the `gpu` marker and skips, inside a fixture, when JAX's first device is
not a GPU. Run on the card with:
    python -m pytest tests_gpu -q
(chip_smoke.py runs this tier in its own process as its last phase.)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs an NVIDIA GPU (skips elsewhere)")


@pytest.fixture(autouse=True)
def gpu():
    import jax
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {device.platform}")
    return device
