"""Test configuration: force a virtual 8-device CPU platform.

The tests run on the CPU. Multi-device sharding paths are exercised on
a virtual CPU mesh (``--xla_force_host_platform_device_count=8``) so
tests run anywhere; ``python chip_smoke.py`` is the check on the GPU.
Environment must be set before the first JAX import, hence this
module-level block.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # override any preset accelerator
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Tests validate numerics against float64 host references.
os.environ.setdefault("JAX_ENABLE_X64", "1")

# Pin the platform in the config too (after import, before any backend
# use), so a preset accelerator platform cannot take over the tests.
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)

