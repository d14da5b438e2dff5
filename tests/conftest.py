"""Test configuration: force the CPU backend with an 8-device virtual mesh
so multi-device sharding paths are exercised without accelerators.

Tests marked ``gpu`` need an NVIDIA GPU.  They take the ``gpu`` fixture,
which skips them on any other backend, so the CPU suite skips them.  On a
GPU host, ``CUSDR_GPU_TESTS=1 python -m pytest tests/ -m gpu`` leaves the
backend alone and runs them.
"""

import os

import pytest

ON_GPU = os.environ.get("CUSDR_GPU_TESTS") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu", jax.devices()


@pytest.fixture
def gpu():
    """Skip unless the process runs on an NVIDIA GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (CUSDR_GPU_TESTS=1 on the card)")
