"""Exactness of the sort-free median selection."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pyspectrogram_tpu.ops import stft
from pyspectrogram_tpu.ops.stft import median_over_time


@pytest.mark.parametrize("n", [2, 3, 5, 64, 127, 128])
def test_median_matches_numpy_exactly(n):
    rng = np.random.default_rng(n)
    p = rng.standard_normal((n, 3, 65)).astype(np.float32)  # incl. negatives
    got = np.asarray(jax.jit(median_over_time)(jnp.asarray(p)))
    want = np.median(p, axis=0).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_median_with_duplicates_and_zeros():
    rng = np.random.default_rng(0)
    p = np.abs(np.round(rng.standard_normal((64, 2, 33)) * 2)).astype(np.float32)
    got = np.asarray(jax.jit(median_over_time)(jnp.asarray(p)))
    np.testing.assert_array_equal(got, np.median(p, axis=0).astype(np.float32))


def test_median_valid_prefix():
    rng = np.random.default_rng(1)
    p = rng.standard_normal((16, 1, 8)).astype(np.float32)
    got = np.asarray(
        jax.jit(lambda x: median_over_time(x, ntime_valid=11))(jnp.asarray(p))
    )
    np.testing.assert_array_equal(got, np.median(p[:11], axis=0).astype(np.float32))


def test_median_float64_path():
    rng = np.random.default_rng(2)
    with jax.enable_x64(True):
        p = rng.standard_normal((10, 2, 7))
        got = np.asarray(jax.jit(median_over_time)(jnp.asarray(p)))
        np.testing.assert_array_equal(got, np.median(p, axis=0))


def test_network_median_exact_all_small_n():
    """The Batcher-network fast path (n <= 32) must equal numpy's median
    bit-for-bit for every row count, odd and even."""
    from pyspectrogram_tpu.ops.stft import MEDIAN_NETWORK_MAX_N

    rng = np.random.default_rng(12)
    for n in range(1, MEDIAN_NETWORK_MAX_N + 1):
        x = rng.standard_normal((n, 2, 130)).astype(np.float32)
        got = np.asarray(stft.median_over_time(jnp.asarray(x)))
        np.testing.assert_array_equal(
            got, np.median(x, axis=0).astype(np.float32))
    # ntime_valid prefix selection also routes through the network
    x = rng.standard_normal((40, 2, 130)).astype(np.float32)
    got = np.asarray(stft.median_over_time(jnp.asarray(x), ntime_valid=7))
    np.testing.assert_array_equal(
        got, np.median(x[:7], axis=0).astype(np.float32))


@pytest.mark.parametrize("n,shape", [(33, (2, 256)), (100, (1, 128)),
                                     (128, (2, 512)), (64, (384,)),
                                     (65, (3, 128))])
def test_bisection_median_exact_above_network(n, shape):
    """Above the sorting-network tier (n > 32) the 33-step bisection must
    equal numpy bit-for-bit: odd/even n, ties, infs, multi-batch."""
    rng = np.random.default_rng(4)
    for x in (
        rng.standard_normal((n, *shape)).astype(np.float32),
        rng.integers(-4, 4, (n, *shape)).astype(np.float32),  # ties
        np.where(rng.random((n, *shape)) < 0.15, np.float32(np.inf),
                 rng.standard_normal((n, *shape)).astype(np.float32)),
    ):
        got = np.asarray(jax.jit(stft.median_over_time)(jnp.asarray(x)))
        np.testing.assert_array_equal(
            got, np.median(x, axis=0).astype(np.float32))
