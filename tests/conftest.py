"""Test harness: force CPU backend with 8 virtual devices (multi-chip
sharding tests run on a virtual mesh, per the driver's dryrun contract) and
f64 enabled before JAX initialises."""

import os

# Force CPU even where JAX would find a GPU: the tests check correctness at
# small sizes, and a test process must not take a card another process
# holds.  jax.config.update below settles the platform before any backend
# starts.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax

jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

DATA_DIR = pathlib.Path("/root/reference/data")


@pytest.fixture(scope="session")
def data_dir():
    if not DATA_DIR.exists():
        pytest.skip("reference data directory not available")
    return DATA_DIR
