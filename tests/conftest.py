"""Test configuration: force an 8-device virtual CPU mesh.

The test suite runs entirely on CPU (multi-device logic is exercised on a
virtual device mesh, the standard JAX practice — SURVEY.md §4).  The
platform override happens here, before any backend is initialized, so the
suite stays on the CPU even on a machine with an accelerator.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
