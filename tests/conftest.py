"""Test harness configuration.

Forces JAX onto a virtual 8-device CPU mesh (the reference has no multi-node
test story; SURVEY.md §4 prescribes exactly this XLA_FLAGS approach) and
enables float64 so compat-mode numerics match the reference's C++ doubles.
Must run before jax initializes a backend.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# The suite runs on the CPU (float64 parity + virtual 8-device mesh), also
# where jax was imported before this file set JAX_PLATFORMS.  Tests that need
# a GPU take the ``gpu_device`` fixture and are run on the card by
# chip_smoke.py.  No persistent compile cache: workers share the checkout.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from fdoct_tpu.config import PipelineConfig  # noqa: E402


@pytest.fixture(scope="session")
def small_cfg() -> PipelineConfig:
    """A small, fast config exercising every pipeline stage (binning,
    zero-pad, non-power-of-two FFT size)."""
    return PipelineConfig(
        width=256, height=64, binvalue=2, averages=3,
        numfftpoints=320, numdisplaypoints=100,
        lambdamin=816e-9, lambdamax=884e-9,
        increasefftpointsmultiplier=2, mediann=0, movavgn=0,
        dtype="float64", compat=True,
    )


@pytest.fixture(scope="session")
def rng() -> np.random.Generator:
    return np.random.default_rng(42)


@pytest.fixture()
def gpu_device():
    """The first GPU, for tests marked ``gpu``.  Decided here at run time,
    never at import: where JAX has no GPU (this suite pins the CPU) the
    test skips; chip_smoke.py runs it on the card."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this test on the card")
    return dev
