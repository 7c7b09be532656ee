import os
import sys

# Smoke tests and benches must see the REAL device count (1 CPU device) —
# only launch/dryrun.py forces 512 placeholder devices, in its own process.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    # bare container: run property tests via the deterministic fallback
    import _hypothesis_fallback

    sys.modules["hypothesis"] = _hypothesis_fallback

import jax  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips without them)")
