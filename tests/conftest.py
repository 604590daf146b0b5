import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import pytest

# Smoke tests run on ONE CPU device (the dry-run sets its own 512-device
# flag in a separate process) — do NOT set XLA_FLAGS here.
jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run slow tests (full dry-run subprocess, etc.)")


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: needs --runslow")
    config.addinivalue_line(
        "markers", "gpu: launches a CUDA kernel of repro_torch; skipped "
        "(inside the test, with a reason) where there is no CUDA device")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="needs --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
