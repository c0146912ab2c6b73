"""Checks that only mean something on the card. They skip on the CPU;
run them there with ``PSTPU_GPU_TESTS=1 python -m pytest -m gpu tests/``
(``chip_smoke.py`` covers the same ground at full size)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pyspectrogram_tpu.models.streaming import StreamingSti
from pyspectrogram_tpu.ops import reference as oracle
from pyspectrogram_tpu.ops import stft

pytestmark = pytest.mark.gpu


def test_headline_step_matches_oracle_on_gpu(gpu):
    """cuFFT float32 vs the float64 oracle at the headline shape."""
    nfft, nint, ntime = 4096, 4, 128
    rng = np.random.default_rng(0)
    pm = rng.standard_normal((4, nfft * nint * ntime)).astype(np.float32)
    starts = (np.arange(ntime) * nfft * nint).astype(np.int32)
    out = stft.make_sti_fn_pm(nfft=nfft, nint=nint, contiguous=True,
                              return_linear=True)(jnp.asarray(pm),
                                                  jnp.asarray(starts))
    x = (pm[0::2] + 1j * pm[1::2].astype(np.float64)).T
    block = np.stack([x[s:s + nfft * nint] for s in starts], axis=1)
    want = oracle.sti_psd(block, nfft, nint=nint, mode="welch")
    np.testing.assert_allclose(np.moveaxis(np.asarray(out["sxx"]), -1, 0),
                               want, rtol=1e-4)
    np.testing.assert_array_equal(
        np.asarray(out["sxx_med"]),
        np.median(np.asarray(out["sxx"]), axis=0).astype(np.float32))


def test_push_donates_state_on_gpu(gpu):
    s = StreamingSti(nfft=1024, nsub=2, block_len=4096, ring_len=8)
    st0 = s.init_state()
    st1, _ = s.push(st0, jnp.zeros((4, 4096), jnp.float32))
    jax.block_until_ready(st1.ring)
    assert st0.ring.is_deleted() and not st1.ring.is_deleted()
