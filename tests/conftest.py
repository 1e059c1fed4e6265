"""Test configuration: the CPU backend with a virtual 8-device mesh.

Multi-device logic is validated on virtual CPU devices (the reference's
analog: multi-GPU tests skip below a device-count threshold; see SURVEY.md
§4). JAX reads JAX_PLATFORMS when it is imported, so a value set from
outside wins: the `gpu`-marked tests run on the card with
`JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu` (they compare with
the CPU backend), and skip through the `gpu` fixture everywhere else. In a
process that imported JAX before pytest (chip_smoke.py) the backends stay
as that process chose them.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax


@pytest.fixture
def gpu():
    """JAX's first device; skips the test unless it is a GPU (decided when
    the test runs, never at import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; jax.devices()[0].platform is {dev.platform!r}")
    return dev
