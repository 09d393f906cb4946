"""Test configuration: an 8-device virtual CPU mesh by default.

The suite runs on the CPU unless ``JAX_PLATFORMS`` names another
platform. Tests marked ``chip`` need an NVIDIA GPU; they skip elsewhere
(decided inside a fixture, never at import) and run on a card with:

    JAX_PLATFORMS=cuda python -m pytest -m chip tests/
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import subprocess

import pytest

_here = os.path.dirname(os.path.abspath(__file__))
# build the native helpers fresh so tests never exercise a stale .so
# (binaries are gitignored; numpy fallbacks cover their absence)
subprocess.run(["make", "-C", os.path.join(_here, "..", "native"), "-s"],
               check=False, capture_output=True)

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _chip_only(request):
    """Skip a ``chip``-marked test unless JAX's backend is a GPU."""
    if request.node.get_closest_marker("chip") is not None and \
            jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (backend is %s)"
                    % jax.default_backend())


def pytest_collection_modifyitems(config, items):
    """Default profile: skip @pytest.mark.slow (long CPU runs) so
    `pytest -q` finishes in minutes on a small box; every engine keeps
    fast coverage. Full profile: NSX_FULL_TESTS=1 (or an explicit -m
    selection)."""
    if os.environ.get("NSX_FULL_TESTS") or config.option.markexpr:
        return
    skip = pytest.mark.skip(
        reason="slow profile: set NSX_FULL_TESTS=1 to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
