"""GEMM-formulated FFT building blocks (host-side planning).

An FFT expressed as two small dense DFT matmuls + a twiddle (the classic
4-step / Cooley-Tukey factorization, SURVEY.md §7.3). The DFT and twiddle
matrices feed the distributed FFT tiers (parallel.dist_fft,
parallel.big_sti) and the time-major ``fft_impl="gemm"`` path of
ops.stft.make_sti_fn.

Math: for N = N1*N2, index n = N2*p + q, k = N1*k2 + k1:
    X[N1*k2 + k1] = sum_q ( W_N^(q*k1) * sum_p x[N2*p + q] * W_N1^(p*k1) )
                    * W_N2^(q*k2)
so with x2[p, q] = x[N2*p + q]:
    Y  = D1 @ x2          (N1,N1)@(N1,N2) — stage-1 DFT along p
    Z  = Y * T            twiddle T[k1, q] = W_N^(q*k1)
    Xm = Z @ D2           (N1,N2)@(N2,N2) — stage-2 DFT along q
    X[N1*k2 + k1] = Xm[k1, k2]   (i.e. flatten Xm transposed)
All matrices are precomputed here in float64 then cast to float32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np


class FFTPlan(NamedTuple):
    nfft: int
    n1: int
    n2: int
    d1r: np.ndarray  # (n1, n1) stage-1 DFT real
    d1i: np.ndarray  # (n1, n1) stage-1 DFT imag
    d2r: np.ndarray  # (n2, n2) stage-2 DFT real
    d2i: np.ndarray  # (n2, n2) stage-2 DFT imag
    twr: np.ndarray  # (n1, n2) twiddle real
    twi: np.ndarray  # (n1, n2) twiddle imag


def dft_mat(n: int) -> np.ndarray:
    """Dense n-point DFT matrix W[j, k] = exp(-2pi*i*jk/n), complex128.
    The single shared builder behind every GEMM-FFT plan in the package
    (this module, parallel.big_sti local stages, parallel.dist_fft)."""
    k = np.arange(n)
    return np.exp(-2j * np.pi * np.outer(k, k) / n)


def twiddle_mat(n1: int, n2: int, nfft: int | None = None) -> np.ndarray:
    """Twiddle T[p, q] = exp(-2pi*i*pq/nfft) for the split N = n1*n2
    (``nfft`` defaults to n1*n2; pass it explicitly for nested splits
    like the 3-stage kernel's T1), complex128."""
    if nfft is None:
        nfft = n1 * n2
    return np.exp(
        -2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / nfft)


def split_factors(nfft: int) -> Tuple[int, int]:
    """(n1, n2) with n1*n2 == nfft, n1 = 128 where possible and n2 at
    most 512 (both powers of two), so both DFT matrices stay small."""
    if nfft & (nfft - 1):
        raise ValueError("GEMM FFT requires power-of-two nfft")
    n1 = min(128, nfft)
    while nfft // n1 > 512:
        n1 *= 2
    return n1, nfft // n1


@functools.lru_cache(maxsize=32)
def make_plan(nfft: int, dtype=np.float32) -> FFTPlan:
    n1, n2 = split_factors(nfft)
    d1 = dft_mat(n1)               # D1[k1, p]
    d2 = dft_mat(n2)               # D2[q, k2] (symmetric)
    tw = twiddle_mat(n1, n2)       # T[k1, q]
    return FFTPlan(
        nfft, n1, n2,
        d1.real.astype(dtype), d1.imag.astype(dtype),
        d2.real.astype(dtype), d2.imag.astype(dtype),
        tw.real.astype(dtype), tw.imag.astype(dtype),
    )


def gemm_fft_numpy(xr: np.ndarray, xi: np.ndarray, plan: FFTPlan
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Reference implementation of the factorized FFT for (..., nfft)
    real/imag planes; returns (Xr, Xi) in natural bin order. Used to
    validate the plan."""
    n1, n2 = plan.n1, plan.n2
    sh = xr.shape[:-1]
    x2r = xr.reshape(sh + (n1, n2))
    x2i = xi.reshape(sh + (n1, n2))
    yr = np.einsum("kp,...pq->...kq", plan.d1r, x2r) - np.einsum(
        "kp,...pq->...kq", plan.d1i, x2i)
    yi = np.einsum("kp,...pq->...kq", plan.d1r, x2i) + np.einsum(
        "kp,...pq->...kq", plan.d1i, x2r)
    zr = yr * plan.twr - yi * plan.twi
    zi = yr * plan.twi + yi * plan.twr
    xmr = zr @ plan.d2r - zi @ plan.d2i
    xmi = zr @ plan.d2i + zi @ plan.d2r
    # X[N1*k2 + k1] = Xm[k1, k2]
    Xr = np.swapaxes(xmr, -1, -2).reshape(sh + (plan.nfft,))
    Xi = np.swapaxes(xmi, -1, -2).reshape(sh + (plan.nfft,))
    return Xr, Xi


def make_gemm_fft(nfft: int):
    """jnp implementation of the factorized complex FFT (for the XLA path
    with fft_impl="gemm"); input (..., nfft) complex, output complex."""
    import jax
    import jax.numpy as jnp

    plan = make_plan(nfft)
    # keep the constants as HOST numpy: jit bakes them into the HLO at
    # trace time; pre-built device arrays would be read back from the
    # device at lowering (mlir.ir_constant -> ._value)
    d1 = (plan.d1r + 1j * plan.d1i).astype(np.complex64)
    d2 = (plan.d2r + 1j * plan.d2i).astype(np.complex64)
    tw = (plan.twr + 1j * plan.twi).astype(np.complex64)
    n1, n2 = plan.n1, plan.n2

    def fft(x):
        sh = x.shape[:-1]
        x2 = x.reshape(sh + (n1, n2))
        # HIGHEST: the default float32 matmul precision is TF32 on the
        # GPU (~1e-3 relative), which would silently degrade this tier
        # below its exact contract; on CPU this is a no-op
        y = jnp.einsum("kp,...pq->...kq", d1, x2,
                       precision=jax.lax.Precision.HIGHEST) * tw
        xm = jnp.matmul(y, d2, precision=jax.lax.Precision.HIGHEST)
        return jnp.swapaxes(xm, -1, -2).reshape(sh + (nfft,))

    return fft
