"""Test configuration: CPU backend with a virtual 8-device mesh, x64 enabled.

Multi-chip code paths (shard_map + collectives) run in CI on a simulated
8-device CPU mesh, the standard JAX approach (SURVEY.md §4.6).

Tests marked ``gpu`` need the card.  They take the ``gpu`` fixture, which
skips them where JAX has no GPU.  To run them on the card, set
``RSP_TEST_DEVICE=gpu`` (``chip_smoke.py`` does): the CPU, virtual-device and
float64 settings below are then left alone, so JAX takes the GPU in float32.
"""

import os

ON_DEVICE = os.environ.get("RSP_TEST_DEVICE") == "gpu"

if not ON_DEVICE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(20250817)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none.

    Decided here, at run time, never at import or collection: every xdist
    worker must collect the same tests.
    """
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {dev.platform})")
    return dev
