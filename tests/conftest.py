"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding paths (otslam_tpu/distributed) are exercised without
accelerator hardware via XLA's host-platform device emulation, per
SURVEY.md §4(c).
"""

import os

# Tests run on the CPU whatever the machine offers: override hard, not
# setdefault.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
