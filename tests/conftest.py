"""Test environment: force an 8-device virtual CPU mesh.

Multi-chip sharding paths are tested without a pod by simulating devices on
the host platform (SURVEY.md section 4.4); this must be configured before
JAX is imported anywhere in the test process.
"""

import os

# PSTPU_GPU_TESTS=1 leaves the platform to JAX so the `gpu`-marked tests
# can run on a card (`PSTPU_GPU_TESTS=1 python -m pytest -m gpu tests/`);
# everything else runs on the CPU with 8 virtual devices.
ON_GPU = os.environ.get("PSTPU_GPU_TESTS") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"  # force: the host may have a GPU
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    # The host image may import/configure jax at interpreter start, in
    # which case the env var above is read too late — update the live
    # config as well, before any backend initializes.
    jax.config.update("jax_platforms", "cpu")
# entry points under test (the CLI) point the persistent compile cache at
# the checkout; test workers must not write it
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def tone_capture(tmp_path_factory):
    """Small 2-subchannel complex64 tone capture written through the
    framework's own Digital RF writer."""
    from pyspectrogram_tpu.io.synthetic import write_capture

    top = tmp_path_factory.mktemp("drf_tone")
    meta = write_capture(
        top,
        channel="ch0",
        kind="tone",
        n_samples=1 << 16,
        sample_rate_numerator=1_000_000,
        num_subchannels=2,
        noise_rms=1e-3,
        dtype=np.complex64,
    )
    return top, meta


@pytest.fixture(scope="session")
def int16_capture(tmp_path_factory):
    """Complex int16 capture (tests the dBFS integer reference rule)."""
    from pyspectrogram_tpu.io.synthetic import write_capture

    top = tmp_path_factory.mktemp("drf_i16")
    dtype = np.dtype([("r", np.int16), ("i", np.int16)])
    meta = write_capture(
        top,
        channel="chI",
        kind="tone",
        n_samples=1 << 15,
        sample_rate_numerator=250_000,
        num_subchannels=1,
        dtype=dtype,
    )
    return top, meta


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with PSTPU_GPU_TESTS=1 on the card; "
                    "chip_smoke.py checks the same on the card)")
