"""Test harness: JAX on a virtual 8-device CPU platform.

Multi-device sharding tests run on host CPU devices.  Tests marked `gpu`
need the card and skip here; run them there with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/` (chip_smoke.py
covers the same comparisons at full size).
"""
import os

# CPU unless the run explicitly asks for the GPU (the `gpu` tests, which
# compare with references on the CPU device, so the CPU stays enabled)
if "cuda" in os.environ.get("JAX_PLATFORMS", ""):
    if "cpu" not in os.environ["JAX_PLATFORMS"]:
        os.environ["JAX_PLATFORMS"] += ",cpu"
else:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# a plugin may have imported jax before the environment was set
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1673551)
