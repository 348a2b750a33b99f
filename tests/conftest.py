"""Test configuration: an 8-device virtual CPU mesh, and the test markers.

Multi-device sharding is validated without accelerators by running JAX on
the host platform with 8 virtual devices (see SURVEY.md §4).  The platform
is ``JAX_PLATFORMS`` when set and the CPU otherwise, so a bare ``pytest``
stays on the CPU; ``JAX_PLATFORMS=cuda python -m pytest tests/ -m chip``
runs the GPU tests on a GPU host.  XLA_FLAGS must be set before the
backend initializes.

Markers: ``chip`` marks a test that needs the GPU (it skips elsewhere,
deciding inside its fixture, never at import); ``slow`` marks a test left
out of the default run (``-m 'not slow'``).
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs the GPU; skips with a reason elsewhere"
    )
    config.addinivalue_line(
        "markers", "slow: left out of the default run (-m 'not slow')"
    )


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU: run on the card (see README)")
    return devices[0]
