"""Spectral filtering and signal regeneration (wishlist kernels).

The reference's README lists these as desired-but-missing features
(reference: README.md:16-20): high/low-pass filtering of the data and
regenerating a time signal ("audio") from a spectrogram subset. Here they
are first-class jitted kernels:

* complex STFT (analysis)  — strided frames, window, FFT;
* spectral masks           — low/high/band-pass or band-stop over the
                             fftshifted frequency axis;
* inverse STFT (synthesis) — windowed overlap-add with COLA normalization;
* filter_signal            — STFT -> mask -> ISTFT round trip.

All device work happens on plane-packed real arrays at the boundary,
like every other device buffer in the package.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from pyspectrogram_tpu.ops.windows import WindowSpec, get_window


def band_mask(
    nfft: int,
    sample_rate: float,
    kind: str,
    cutoff_hz,
    shifted: bool = False,
) -> np.ndarray:
    """(nfft,) float32 {0,1} mask over the UNshifted FFT bin order
    (set ``shifted`` for an fftshifted-axis mask).

    kind: "lowpass" | "highpass" (scalar cutoff, on |f|) or
          "bandpass" | "bandstop" ((f_lo, f_hi) band, signed frequencies).
    """
    f = np.fft.fftfreq(nfft, 1.0 / float(sample_rate))
    if kind == "lowpass":
        m = np.abs(f) <= float(cutoff_hz)
    elif kind == "highpass":
        m = np.abs(f) >= float(cutoff_hz)
    elif kind == "bandpass":
        lo, hi = cutoff_hz
        m = (f >= lo) & (f <= hi)
    elif kind == "bandstop":
        lo, hi = cutoff_hz
        m = ~((f >= lo) & (f <= hi))
    else:
        raise ValueError(f"unknown filter kind {kind!r}")
    m = m.astype(np.float32)
    return np.fft.fftshift(m) if shifted else m


@functools.lru_cache(maxsize=64)
def make_stft_fn(*, nfft: int, hop: int, window: WindowSpec = "hann"):
    """Jitted complex STFT: packed (n, 2) -> (nframes, nfft, 2) packed
    spectra (unshifted bin order). nframes = (n - nfft)//hop + 1."""
    win = jnp.asarray(get_window(window, nfft).astype(np.float32))

    @jax.jit
    def stft(x_packed: jax.Array) -> jax.Array:
        n = x_packed.shape[0]
        nframes = (n - nfft) // hop + 1
        if nframes < 1:  # static shape — raises at trace time, not on device
            raise ValueError(
                f"signal too short for STFT: n={n} < nfft={nfft}")
        starts = jnp.arange(nframes, dtype=jnp.int32) * hop

        def one(s):
            return jax.lax.dynamic_slice(x_packed, (s, 0), (nfft, 2))

        fr = jax.vmap(one)(starts)                      # (nframes, nfft, 2)
        c = jax.lax.complex(fr[..., 0], fr[..., 1]) * win
        X = jnp.fft.fft(c, axis=-1)
        return jnp.stack([jnp.real(X), jnp.imag(X)], axis=-1)

    return stft


@functools.lru_cache(maxsize=64)
def make_istft_fn(*, nfft: int, hop: int, window: WindowSpec = "hann",
                  nframes: int):
    """Jitted inverse STFT (windowed overlap-add, least-squares COLA
    normalization). (nframes, nfft, 2) packed spectra -> (n, 2) packed
    signal with n = (nframes-1)*hop + nfft."""
    if nframes < 1:
        raise ValueError(f"inverse STFT needs at least one frame, "
                         f"got nframes={nframes}")
    win64 = get_window(window, nfft)
    n_out = (nframes - 1) * hop + nfft
    # COLA normalization: sum of squared synthesis windows at each sample
    norm = np.zeros(n_out)
    for k in range(nframes):
        norm[k * hop : k * hop + nfft] += win64 ** 2
    inv_norm = jnp.asarray((1.0 / np.maximum(norm, 1e-30)).astype(np.float32))
    win = jnp.asarray(win64.astype(np.float32))

    @jax.jit
    def istft(spectra_packed: jax.Array) -> jax.Array:
        X = jax.lax.complex(spectra_packed[..., 0], spectra_packed[..., 1])
        seg = jnp.fft.ifft(X, axis=-1) * win            # (nframes, nfft)

        def body(k, acc):
            upd = jax.lax.dynamic_slice(acc, (k * hop, 0), (nfft, 2))
            s = seg[k]
            upd = upd + jnp.stack([jnp.real(s), jnp.imag(s)], axis=-1)
            return jax.lax.dynamic_update_slice(acc, upd, (k * hop, 0))

        y = jax.lax.fori_loop(0, nframes, body, jnp.zeros((n_out, 2), jnp.float32))
        return y * inv_norm[:, None]

    return istft


def filter_signal(
    x: np.ndarray,
    sample_rate: float,
    kind: str,
    cutoff_hz,
    nfft: int = 1024,
    hop: Optional[int] = None,
    window: WindowSpec = "hann",
) -> np.ndarray:
    """High/low/band-pass filter a complex signal in the STFT domain and
    regenerate the time signal (README wishlist items, README.md:16-20).

    x: (n,) complex host array; returns (n',) complex64 with
    n' = nframes*hop + (nfft-hop) <= n (tail samples beyond the last full
    frame are dropped).
    """
    hop = nfft // 2 if hop is None else hop
    mask = jnp.asarray(band_mask(nfft, sample_rate, kind, cutoff_hz))
    packed = np.ascontiguousarray(x.astype(np.complex64)).view(np.float32)
    packed = packed.reshape(-1, 2)
    stft = make_stft_fn(nfft=nfft, hop=hop, window=window)
    spectra = stft(jnp.asarray(packed))
    spectra = spectra * mask[None, :, None]
    nframes = spectra.shape[0]
    istft = make_istft_fn(nfft=nfft, hop=hop, window=window, nframes=nframes)
    y = np.asarray(istft(spectra))
    return y[:, 0] + 1j * y[:, 1]


def save_wav(path: str, x: np.ndarray, sample_rate: int,
             mode: str = "real") -> str:
    """Write a regenerated signal as a 16-bit WAV file — the reference's
    audio-regeneration wishlist end product (README.md:17; the reference
    descends from an audio spectrogram tool).

    mode: "real" takes the real part (baseband audio), "mag" the
    magnitude envelope. The signal is peak-normalized to 0.9 FS.
    """
    from scipy.io import wavfile

    if not path.lower().endswith(".wav"):
        path += ".wav"
    y = np.real(x) if mode == "real" else np.abs(x)
    peak = np.max(np.abs(y)) or 1.0
    pcm = np.round(y / peak * 0.9 * 32767).astype(np.int16)
    wavfile.write(path, int(sample_rate), pcm)
    return path


def regenerate_signal(
    spectra_packed: np.ndarray,
    nfft: int,
    hop: Optional[int] = None,
    window: WindowSpec = "hann",
    freq_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Regenerate a time signal from (a masked subset of) complex STFT
    spectra — the reference wishlist's 'regenerate audio from a spectrogram
    subset' (README.md:17)."""
    hop = nfft // 2 if hop is None else hop
    spectra = jnp.asarray(spectra_packed)
    if freq_mask is not None:
        spectra = spectra * jnp.asarray(freq_mask, jnp.float32)[None, :, None]
    istft = make_istft_fn(nfft=nfft, hop=hop, window=window,
                          nframes=spectra.shape[0])
    y = np.asarray(istft(spectra))
    return y[:, 0] + 1j * y[:, 1]
