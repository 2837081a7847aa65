"""Test configuration: CPU backend with 8 virtual devices, float64 on.

Multi-device hardware is not needed for the sharding tests: they run on a
virtual 8-device CPU mesh per the standard JAX testing recipe. XLA_FLAGS
must be set before the CPU backend initializes. Tests that need a GPU are
marked ``gpu`` and decide inside the ``gpu_device`` fixture whether one is
present; here (CPU only) they skip.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# CPU unless JAX_PLATFORMS says otherwise: the GPU-marked tests run on the
# card with JAX_PLATFORMS=cuda,cpu (README "Running")
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from magi_v2_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# persistent compilation cache: the NUTS/scan graphs dominate CI wall time
# and are identical across runs
enable_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip when this process has none.

    Decided here, at test time — never at import or collection — so every
    pytest-xdist worker collects the same tests."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run on the card: see README 'Running')")
    return devs[0]
