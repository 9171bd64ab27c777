"""Test config: run on a virtual 8-device CPU mesh so sharding tests work
without an accelerator.

``PSDR_TEST_ON_CARD=1`` (set by ``chip_smoke.py`` before it runs the
card-only tests in its own process) leaves the backend alone.  Whether a
card is present is decided by the ``gpu`` fixture, never at import.
"""

import os

import pytest

if os.environ.get("PSDR_TEST_ON_CARD") != "1":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running optimization test")
    config.addinivalue_line(
        "markers", "chip: needs a GPU; run on the card by chip_smoke.py")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
    return jax.devices()[0]
