"""Test configuration: force CPU with 8 virtual devices.

Tests run without a GPU; multi-device sharding is validated on a virtual
8-device CPU mesh (SURVEY.md §5.8), and Pallas kernels run in interpret
mode. The platform is also forced via jax.config after import, in case
something selected another one programmatically.

Tests that need the card carry the ``gpu`` marker (pyproject.toml) and
skip here: they decide inside a fixture (``gpu_device``), never at import.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where there is none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run on the card: python -m pytest -m gpu)")
    return gpus[0]
