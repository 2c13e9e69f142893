"""Test harness: JAX on the CPU with 8 virtual devices, unless asked otherwise.

The tests run on the CPU (``JAX_PLATFORMS=cpu``, set here when the caller set
nothing); sharding is checked on the 8 virtual CPU devices. Tests marked
``gpu`` need an NVIDIA card and skip elsewhere; on the card run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

# the persistent compile cache would only churn the disk in a test run
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu():
    """The first JAX device, or skip when it is not an NVIDIA GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX runs on {dev.platform})")
    return dev
