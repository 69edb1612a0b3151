"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The platform is forced through jax.config before the backend initializes, so
the suite runs on the CPU even on a machine with a GPU, and the mesh tests get
8 virtual devices. The GPU path is exercised by ``chip_smoke.py`` and
``bench.py``.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)
