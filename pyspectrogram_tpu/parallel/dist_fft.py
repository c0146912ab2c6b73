"""Distributed 4-step FFT over a device mesh.

The reference caps single FFTs at 2^20 points computed on one CPU core
(reference: drfview.py:475); here the transform can shard across
devices instead (SURVEY.md sections 2.3/5: the Ulysses-analogue axis). Classic 4-step factorization N = N1 * N2 with
x2[p, q] = x[p*N2 + q] sharded over the q (column) axis:

  1. local stage:  Y = DFT_N1 along p      (each device holds all p for
                                            its q-slice -> pure local FFT)
  2. local twiddle Z[p, q] = Y[p, q] * W_N^(q p)
  3. all-to-all:   transpose the shard axis q -> p across devices
  4. local stage:  X' = DFT_N2 along q     (each device now holds all q
                                            for its p-slice)

Output element X[N1*k2 + k1] = X'[k1, k2]; :func:`distributed_fft` returns
the (N1, N2) matrix sharded over k1 (natural order = transpose-flatten,
which callers fold into downstream indexing or undo with one reshape).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyspectrogram_tpu.kernels.gemm_fft import twiddle_mat


def split_for_devices(nfft: int, ndev: int) -> Tuple[int, int]:
    """(n1, n2) power-of-two split with both axes divisible by ndev."""
    if nfft & (nfft - 1):
        raise ValueError("distributed FFT requires power-of-two nfft")
    n1 = 1 << ((nfft.bit_length() - 1) // 2)
    n2 = nfft // n1
    if n1 % ndev or n2 % ndev:
        raise ValueError(f"nfft {nfft} not splittable over {ndev} devices")
    return n1, n2


@functools.lru_cache(maxsize=16)
def _twiddle(n1: int, n2: int):
    # full (n1, n2) twiddle as numpy; each shard slices its q columns
    t = twiddle_mat(n1, n2)
    return np.stack([t.real, t.imag], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def make_distributed_fft(mesh: Mesh, axis: str, nfft: int):
    """Build ``f(xr, xi) -> (Xr, Xi)`` computing an nfft-point complex FFT
    sharded over ``mesh[axis]``.

    Inputs/outputs are real/imag planes of shape (n1, n2): inputs sharded
    over columns (P(None, axis)), outputs over rows (P(axis, None)) with
    X[n1*k2 + k1] = out[k1, k2]. All collective traffic is one all-to-all.

    Cached like every other jit factory here (Mesh hashes on device ids +
    axis layout): a repeat call must reuse the compiled program — a fresh
    jit wrapper per call would recompile on every request.
    """
    ndev = mesh.shape[axis]
    n1, n2 = split_for_devices(nfft, ndev)
    tw = _twiddle(n1, n2)

    def local(xr, xi, twr, twi):
        # stage 1: DFT along p (axis 0) — local, shard holds all p
        c = jax.lax.complex(xr, xi)
        y = jnp.fft.fft(c, axis=0)
        # twiddle (shard's q columns)
        y = y * jax.lax.complex(twr, twi)
        # all-to-all: shard axis q -> p  ((n1, n2/ndev) -> (n1/ndev, n2))
        y = y.reshape(ndev, n1 // ndev, n2 // ndev)
        y = jax.lax.all_to_all(y, axis, split_axis=0, concat_axis=0,
                               tiled=False)
        # y: (ndev, n1/ndev, n2/ndev) with leading dim = source shard = q block
        y = jnp.moveaxis(y, 0, 1).reshape(n1 // ndev, n2)
        # stage 2: DFT along q (axis 1) — local, shard now holds all q
        x = jnp.fft.fft(y, axis=1)
        return jnp.real(x), jnp.imag(x)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(None, axis), P(None, axis)),
        out_specs=(P(axis, None), P(axis, None)),
        check_vma=False,
    )

    twr = jnp.asarray(tw[..., 0])
    twi = jnp.asarray(tw[..., 1])

    @jax.jit
    def dist_fft(xr: jax.Array, xi: jax.Array):
        return fn(xr, xi, twr, twi)

    dist_fft.input_sharding = NamedSharding(mesh, P(None, axis))
    dist_fft.n1n2 = (n1, n2)
    return dist_fft


def reference_order(xm: np.ndarray) -> np.ndarray:
    """(n1, n2) 4-step output -> natural (nfft,) bin order."""
    return np.asarray(xm).T.reshape(-1)
