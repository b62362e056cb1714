"""Test config: run on the CPU with 8 virtual devices so the
data-parallel mesh paths are exercised without accelerators (SURVEY.md §4).

The CPU is pinned unless ``JAX_PLATFORMS`` names a platform. Tests marked
``gpu`` need a CUDA card and skip elsewhere; on a machine with one, run
them in one process (a JAX process reserves most of the card's memory):

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped on other platforms")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    # decided per test at run time, never at collection: every xdist
    # worker must collect the same tests
    if (request.node.get_closest_marker("gpu")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a CUDA card")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
