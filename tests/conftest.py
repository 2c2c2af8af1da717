"""Test config: JAX on the CPU with 8 virtual devices, so mesh and
collective tests run without accelerators (SURVEY.md §4 multi-host testing
strategy), unless ``JAX_PLATFORMS`` names another platform.

Tests that need the GPU carry the ``gpu`` marker; the ``_gpu_only``
fixture skips them when the first device is not a GPU.  Run them on the
card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` (one
process: no xdist workers, which would each take the card).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(scope="session")
def goldens_dir():
    return GOLDENS


def load_golden(name):
    return np.load(os.path.join(GOLDENS, name))


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests where the first device is not a GPU —
    decided here, at run time, never while a module is imported."""
    if (request.node.get_closest_marker("gpu")
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs an NVIDIA GPU; run with JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/ on the card")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop JAX's in-process executable caches after each test module.

    One long pytest process accumulates hundreds of compiled CPU
    executables (the interpret-mode Pallas suites especially), and jax
    0.9's CPU backend has been seen to crash inside LLVM late in a full
    single-process run once that state piles up.  Clearing per module
    bounds the accumulation; cross-module executable reuse is minimal, so
    the runtime cost is small."""
    yield
    jax.clear_caches()
