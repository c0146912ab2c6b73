"""NumPy oracle: the reference's PSD/STI math, exactly.

This is the ground truth the device programs are golden-tested against
(SURVEY.md section 4.1). It re-derives — from the math, not the code — what
``sti_proc_data`` computes (reference: drfProc.py:364-403):

* periodic Kaiser beta=1.7 window of length nfft (reference: drfProc.py:386);
* two-sided, detrend-free, 'spectrum'-scaled periodogram along axis 0
  (reference: drfProc.py:387-396): ``|FFT(win*x[:nfft])|^2 / win.sum()^2``.
  Note the verified truncation semantics: because scipy's periodogram crops
  the input to its first nfft samples when nfft < len(x), only the FIRST of
  every nint frames contributes — "parity" mode reproduces that; "welch"
  mode does the true nint-segment average the GUI label implies;
* fftshifted two-sided frequency axis (reference: drfProc.py:398-399);
* median PSD across STI columns (reference: drfProc.py:401);
* dB conversion ``10*log10(x + 1e-15)`` (reference: drfProc.py:308-310).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from pyspectrogram_tpu.ops.windows import WindowSpec, get_window


def periodogram_psd(x: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Two-sided 'spectrum'-scaled periodogram of frames along the LAST axis.

    x: (..., nfft) real or complex; window: (nfft,).
    Returns (..., nfft) power, unshifted bin order.
    """
    xw = x * window
    X = np.fft.fft(xw, axis=-1)
    scale = 1.0 / np.sum(window) ** 2
    return (X.real ** 2 + X.imag ** 2) * scale


def sti_psd(
    block: np.ndarray,
    nfft: int,
    nint: int = 1,
    mode: str = "parity",
    window: WindowSpec = ("kaiser", 1.7),
) -> np.ndarray:
    """PSD per STI column from a (nfft*nint, ntime, nsub) block.

    Returns sxx (nfft, ntime, nsub) in fftshifted bin order — linear power,
    not dB (the reference applies dB outside the kernel,
    reference: drfProc.py:308-310).
    """
    if block.shape[0] < nfft * (nint if mode == "welch" else 1):
        raise ValueError(
            f"block axis 0 ({block.shape[0]}) shorter than required samples"
        )
    win = get_window(window, nfft)
    # (nsamp, ntime, nsub) -> (ntime, nsub, nsamp): frames on the last axis
    x = np.moveaxis(block, 0, -1)
    if mode == "parity":
        p = periodogram_psd(x[..., :nfft], win)
    elif mode == "welch":
        segs = x[..., : nint * nfft].reshape(x.shape[:-1] + (nint, nfft))
        p = periodogram_psd(segs, win).mean(axis=-2)
    else:
        raise ValueError(f"mode must be 'parity' or 'welch', got {mode!r}")
    p = np.fft.fftshift(p, axes=-1)
    return np.moveaxis(p, -1, 0)  # back to (nfft, ntime, nsub)


def sti_proc(
    block: np.ndarray,
    sample_rate: Union[float, "object"],
    nfft: int,
    nint: int = 1,
    mode: str = "parity",
    window: WindowSpec = ("kaiser", 1.7),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full oracle with the reference's return surface: (f, sxx, sxx_med)
    (reference: drfProc.py:364-403). f in Hz, fftshifted; sxx_med is the
    median across the time axis."""
    sxx = sti_psd(block, nfft, nint=nint, mode=mode, window=window)
    f = np.fft.fftshift(np.fft.fftfreq(nfft, 1.0 / float(sample_rate)))
    sxx_med = np.median(sxx, axis=1)
    return f, sxx, sxx_med


def to_dbfs(x: np.ndarray, eps: float = 1e-15) -> np.ndarray:
    """dB full scale with the reference's epsilon floor
    (reference: drfProc.py:308-310)."""
    return 10.0 * np.log10(x + eps)


def spectrogram_proc(
    x: np.ndarray,
    sample_rate: float,
    nfft: int,
    integration_dt: Optional[float] = None,
    window: WindowSpec = ("kaiser", 1.7),
    noverlap: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One-shot spectrogram with time integration and min/median/max summary
    spectra — capability parity with the reference's alternate (dead-code)
    path ``proc_data`` (reference: drfProc.py:406-453), implemented live.

    ``noverlap`` defaults to ``nfft // 8`` — scipy.signal.spectrogram's
    default, which the reference's proc_data inherits by not passing
    noverlap (reference: drfProc.py:425-433). Pass 0 for non-overlapping
    frames.

    x: (n,) 1-D signal. Returns (t, f, sxx_int, sxx_med, sxx_min, sxx_max).
    """
    win = get_window(window, nfft)
    if noverlap is None:
        noverlap = nfft // 8
    if not 0 <= noverlap < nfft:
        raise ValueError(f"noverlap must be in [0, nfft), got {noverlap}")
    hop = nfft - noverlap
    nseg = (len(x) - noverlap) // hop
    idx = np.arange(nseg)[:, None] * hop + np.arange(nfft)[None, :]
    frames = x[idx]  # (nseg, nfft), strided when noverlap > 0
    p = periodogram_psd(frames, win)  # (nseg, nfft)
    t = (np.arange(nseg) * hop + nfft / 2.0) / float(sample_rate)
    if integration_dt is not None:
        n_int = max(int(integration_dt / (hop / float(sample_rate))), 1)
        edges = np.arange(0, nseg, n_int)
        chunks = [p[edges[i]:edges[i + 1]].mean(axis=0)
                  for i in range(len(edges) - 1)]
        p = np.stack(chunks, axis=0) if chunks else p[:0]
        t = t[edges[:-1]]
    f = np.fft.fftshift(np.fft.fftfreq(nfft, 1.0 / float(sample_rate)))
    p = np.fft.fftshift(p, axes=-1)
    sxx = p.T  # (nfft, ntime)
    return (
        t, f, sxx,
        np.median(sxx, axis=-1), np.min(sxx, axis=-1), np.max(sxx, axis=-1),
    )
