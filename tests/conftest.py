"""Test configuration: run on CPU with 8 fake devices and f64 enabled,
unless ``JAX_PLATFORMS`` names another backend (the ``gpu``-marked tests).

This mirrors the standard JAX recipe for testing multi-chip sharding without
hardware (SURVEY.md §4: xla_force_host_platform_device_count) and gives the
f64 precision needed to meet the reference's SE3 test tolerance
(test_ceres_se3.cpp:80-81).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Tests marked ``gpu`` need the card: run them with
    ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.  Decided here,
    per test, never while modules are imported."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (JAX_PLATFORMS=cuda)")
