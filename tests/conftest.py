"""Test configuration: run on a virtual 8-device CPU mesh by default.

The CPU tests pin JAX to the CPU through jax.config (the driver also exports
``JAX_PLATFORMS=cpu``); XLA_FLAGS must be set before the CPU backend
initializes, which is lazy, so doing it here is early enough.

Tests that need the GPU carry the ``gpu`` marker and take the ``gpu_device``
fixture, which skips them (with a reason) when JAX has no GPU.  Run them on
the card with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)  # allow f64 oracles in tests

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda,cpu)")
    return gpus[0]


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "gpu: runs on the GPU; skipped where JAX has none")
