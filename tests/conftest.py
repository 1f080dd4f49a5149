"""Test configuration: an 8-device virtual CPU mesh, set up before JAX loads.

Multi-device sharding paths are validated on a virtual CPU mesh.  Tests
marked ``gpu`` compare the compiled kernels on a card against the plain
references; they skip unless JAX's default device is a GPU, which needs
``JAX_PLATFORMS=cuda,cpu`` (README, "Tests").
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from sarlacc_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()
jax.config.update("jax_enable_x64", True)  # float64 parity against the oracles

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: compares compiled kernels on a GPU with the references"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The GPU the marked tests run on; decided here, never at import."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev
