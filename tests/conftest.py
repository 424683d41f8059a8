import os
import sys

# The suite runs on the CPU: device-parallel tests on a virtual 8-device
# CPU mesh.  A run that asks for the GPU — ``JAX_PLATFORMS=cuda`` or
# ``-m gpu`` alone — keeps JAX's own platform so the ``gpu``-marked tests
# reach the card (see the ``gpu`` fixture).
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

REFERENCE_TESTS = "/root/reference/tests"
GPU_PLATFORMS = ("cuda", "gpu")


def wants_gpu(platforms_env: str, markexpr: str) -> bool:
    """Whether a run asks for the GPU: ``JAX_PLATFORMS`` names a GPU
    platform, or the mark expression selects exactly the ``gpu`` tests."""
    if any(p.strip() in GPU_PLATFORMS for p in platforms_env.split(",")):
        return True
    return markexpr.strip() == "gpu"


def _run_wants_gpu(config) -> bool:
    return wants_gpu(os.environ.get("JAX_PLATFORMS", ""),
                     config.option.markexpr or "")


def pytest_configure(config):
    # pinned through the config API: JAX may already be imported, but no
    # backend is initialised before collection
    if not _run_wants_gpu(config):
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu(request):
    """Tests marked ``gpu``: skip on a CPU run; fail when the run asked
    for the GPU and JAX sees none (a device check must not turn into a
    skip)."""
    from poasta_tpu.utils import backend

    plat = backend.platform()
    if plat == "gpu":
        return
    if _run_wants_gpu(request.config):
        pytest.fail(f"a GPU run was asked for, but JAX's platform is "
                    f"{plat!r}")
    pytest.skip("needs an NVIDIA GPU (run on the card: "
                "JAX_PLATFORMS=cuda pytest -m gpu tests/)")


@pytest.fixture
def reference_tests_dir():
    if not os.path.isdir(REFERENCE_TESTS):
        pytest.skip("reference test data not available")
    return REFERENCE_TESTS
