"""On-device display tiles: crop + decimate + quantize INSIDE the jit.

The north-star display path (BASELINE.md; the on-device form of the
reference's plot decimation + color quantization, reference:
drfview.py:1006-1023, drfview.py:1043-1057): frequency-window cropping,
fscale decimation and 256-level color quantization all run on device, so
only a uint8 level-index tile — 4-16x smaller than the float spectra —
ever leaves HBM. The host applies an RGBA LUT and composites.

A :class:`TileSpec` is the static (hashable) description of that epilogue:
the reference's decimation plan is always a strided slice of the
fftshifted bin axis (the frequency window keeps a contiguous bin range and
the plan takes every fscale-th kept bin, reference: drfview.py:1006-1023),
so on device it is one ``lax.slice`` — no gather.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np

from pyspectrogram_tpu.display.render import freq_crop_decimate
from pyspectrogram_tpu.utils.config import MAX_PLOT_FREQS


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """Static display-epilogue plan: which fftshifted bins to keep and how
    to map dBFS onto uint8 levels. Hashable, so jitted-function caches can
    key on it."""

    plot_lo: int      #: first kept fftshifted bin index
    plot_step: int    #: decimation stride (the reference's fscale)
    plot_n: int       #: number of plot bins
    cmin: float       #: dBFS mapped to level 0 (clamped below)
    cmax: float       #: dBFS mapped to the top level (clamped above)
    npoints: int = 256  #: quantization levels (reference: drfview.py:1057)

    def __post_init__(self):
        if not (2 <= self.npoints <= 256):
            raise ValueError("npoints must fit uint8 (2..256)")
        if self.plot_n < 1:
            raise ValueError("empty tile: no bins inside the freq window")
        if not self.cmax > self.cmin:
            raise ValueError("cmax must exceed cmin")

    @property
    def plot_indices(self) -> np.ndarray:
        return self.plot_lo + self.plot_step * np.arange(self.plot_n)

    def crop_key(self) -> "TileSpec":
        """The spec with its color range canonicalized — use as the
        compile-cache key. cmin/cmax are RUNTIME operands of the
        quantization (the reference re-clims without rebuilding anything,
        drfview.py:1061-1074, and a recompile here costs seconds), so
        compiled programs must key only on the crop
        plan + level count; the color range rides in as a (2,) float32
        array."""
        return dataclasses.replace(self, cmin=0.0, cmax=1.0)

    @property
    def qparams(self) -> np.ndarray:
        """(2,) float32 [cmin, scale] quantization operand. scale is
        computed in float64 HERE and shipped as float32, so the traced
        math ``(db - cmin) * scale`` is bit-identical to the host numpy
        quantization whatever the color range operand."""
        from pyspectrogram_tpu.display.render import quantize_params

        return quantize_params((self.cmin, self.cmax), self.npoints)


def make_tile_spec(
    freqs_hz: np.ndarray,
    frange_khz: Tuple[float, float],
    crange_db: Tuple[float, float],
    max_nfreqs: int = MAX_PLOT_FREQS,
    npoints: int = 256,
) -> Optional[TileSpec]:
    """Build the TileSpec matching the host decimation plan
    (:func:`display.freq_crop_decimate`) exactly; None if the frequency
    window keeps no bins."""
    idx, _ = freq_crop_decimate(np.asarray(freqs_hz), frange_khz, max_nfreqs)
    if len(idx) == 0:
        return None
    step = int(idx[1] - idx[0]) if len(idx) > 1 else 1
    # the plan is strided by construction for a monotonic (fftshifted)
    # frequency axis; a raw fftfreq-ordered axis breaks that, and the
    # device lax.slice would then read the wrong bins — refuse loudly
    # (a bare assert disappears under python -O)
    if len(idx) > 1 and not (np.diff(idx) == step).all():
        raise ValueError(
            "decimation plan is not a uniform stride — freqs_hz must be "
            "the monotonic fftshifted axis (ops.stft.shifted_freqs)")
    return TileSpec(
        plot_lo=int(idx[0]), plot_step=step, plot_n=len(idx),
        cmin=float(crange_db[0]), cmax=float(crange_db[1]),
        npoints=int(npoints),
    )


def tile_freqs(spec: TileSpec, freqs_hz: np.ndarray) -> np.ndarray:
    """The plot-frequency axis (Hz) the tile's bins correspond to."""
    return np.asarray(freqs_hz)[spec.plot_indices]


def quantize_tile_linear(p_linear, spec: TileSpec, eps: float = 1e-15,
                         qparams=None):
    """Device epilogue: LINEAR fftshifted power (..., nfft) -> uint8 tile
    (..., plot_n). Traced code — call inside jit.

    Crop+decimate happens FIRST (one strided lax.slice), so the dB
    conversion and quantization only touch the kept bins. Elementwise math
    matches the host path (to_dbfs then display.quantize_on_device)
    exactly, so device tiles are bit-identical to host-quantized floats.
    """
    import jax
    import jax.numpy as jnp

    axis = p_linear.ndim - 1
    hi = spec.plot_lo + spec.plot_step * (spec.plot_n - 1) + 1
    sl = jax.lax.slice_in_dim(p_linear, spec.plot_lo, hi, spec.plot_step,
                              axis=axis)
    db = 10.0 * jnp.log10(sl + jnp.asarray(eps, sl.dtype))
    return quantize_db_tile(db, spec, qparams)


def quantize_db_tile(db, spec: TileSpec, qparams=None):
    """dBFS values -> uint8 levels (traced; the quantization half of the
    epilogue, reference: drfview.py:1057 + clamp drfview.py:1515-1516).

    ``qparams``: optional traced (2,) [cmin, scale] operand (see
    TileSpec.qparams) overriding the spec's static color range — pass it
    so color-range changes re-run the SAME compiled program instead of
    compiling a new one (see TileSpec.crop_key)."""
    from pyspectrogram_tpu.display.render import quantize_db_levels

    if qparams is None:
        qparams = spec.qparams
    return quantize_db_levels(db, qparams, spec.npoints)


def quantize_tile_db(db, spec: TileSpec, qparams=None):
    """Device epilogue from dBFS values (..., nfft) -> uint8 tile (traced;
    for paths that already produced dB on device, e.g. the sharded STI)."""
    import jax

    hi = spec.plot_lo + spec.plot_step * (spec.plot_n - 1) + 1
    sl = jax.lax.slice_in_dim(db, spec.plot_lo, hi, spec.plot_step,
                              axis=db.ndim - 1)
    return quantize_db_tile(sl, spec, qparams)


@functools.lru_cache(maxsize=64)
def _make_host_tile_fn(crop: TileSpec, eps: float):
    import jax

    @jax.jit
    def f(p_linear, qparams):
        return quantize_tile_linear(p_linear, crop, eps, qparams)

    return f


@functools.lru_cache(maxsize=64)
def _make_host_db_tile_fn(crop: TileSpec):
    import jax

    @jax.jit
    def f(db, qparams):
        return quantize_tile_db(db, crop, qparams)

    return f


def tile_from_linear(p_linear, spec: TileSpec, eps: float = 1e-15) -> np.ndarray:
    """One-shot helper: device linear power -> host uint8 tile (jitted,
    cached per CROP plan; the color range is a runtime operand)."""
    fn = _make_host_tile_fn(spec.crop_key(), float(eps))
    return np.asarray(fn(p_linear, spec.qparams))


def tile_from_db(db, spec: TileSpec) -> np.ndarray:
    """dBFS spectra (..., nfft) -> host uint8 tile. Device arrays are
    cropped + quantized ON DEVICE before readback; host arrays take the
    identical numpy math (same float32 ops, bit-identical levels)."""
    if isinstance(db, np.ndarray):
        sl = db[..., spec.plot_indices].astype(np.float32, copy=False)
        scale = np.float32((spec.npoints - 1) / (spec.cmax - spec.cmin))
        q = np.round((sl - np.float32(spec.cmin)) * scale)
        return np.clip(q, 0, spec.npoints - 1).astype(np.uint8)
    return np.asarray(_make_host_db_tile_fn(spec.crop_key())(
        db, spec.qparams))
