"""Test configuration: the CPU backend with a virtual 8-device mesh.

Tests run on the CPU unless JAX_PLATFORMS names another platform.  The
card-only tests carry the `gpu` marker and take the `gpu` fixture, which
skips them where the default device is not a GPU; run them on a GPU host
with `JAX_PLATFORMS=cuda python -m pytest tests -m gpu`.
"""

import os
import pathlib

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest

REFERENCE_TEST_DATA = pathlib.Path("/root/reference/test_data")


@pytest.fixture(scope="session")
def ref_data():
    if not REFERENCE_TEST_DATA.is_dir():
        pytest.skip("reference test_data not available")
    return REFERENCE_TEST_DATA


@pytest.fixture
def gpu():
    """The default device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the default device is {dev.platform}")
    return dev
