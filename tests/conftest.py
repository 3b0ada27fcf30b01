"""Test harness config: force the CPU backend with 8 virtual devices so
multi-chip sharding tests run anywhere (SURVEY.md section 4 implication:
multi-host tests via JAX CPU backends).

Tests that need a card carry the `gpu` marker and take the `gpu_device`
fixture, which decides at run time (never at import) and skips when JAX
sees no GPU.  They run on a card with
`VFAST_TEST_GPU=1 python -m pytest -m gpu tests/`, which leaves the
platform to JAX."""

import os

import pytest

if os.environ.get("VFAST_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip with the reason."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (JAX sees none)")
    return devs[0]
