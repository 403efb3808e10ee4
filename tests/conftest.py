"""Test configuration: run JAX on a simulated 8-device CPU mesh.

The reference has no test suite at all (SURVEY.md §4); this repo builds the
full pyramid.  Multi-chip sharding is validated on virtual CPU devices via
``xla_force_host_platform_device_count`` — the "fake backend" pattern — so
the suite runs anywhere; on-card checks live in ``chip_smoke.py`` and the
benchmark in ``bench.py``.
"""

import os

# Force CPU with 8 virtual devices BEFORE any backend initialises.
os.environ.pop("JAX_PLATFORMS", None)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_ROOT = "/root/reference"
SYNTHETIC_DIR = os.path.join(
    REFERENCE_ROOT, "python/data/data_synthetic/syntheticPC_with_transformations")
GROUND_TRUTH = os.path.join(
    REFERENCE_ROOT, "python/data/data_synthetic/defined_transformations.txt")
GOLDEN_4D = os.path.join(REFERENCE_ROOT, "python/results/4DPCReg")
GOLDEN_PAIR = os.path.join(REFERENCE_ROOT, "python/results/PairReg")


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")


@pytest.fixture()
def rng():
    # function-scoped: every test sees the same deterministic stream
    # regardless of execution order
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def synthetic_dir():
    if not os.path.isdir(SYNTHETIC_DIR):
        pytest.skip("reference synthetic data not available")
    return SYNTHETIC_DIR
