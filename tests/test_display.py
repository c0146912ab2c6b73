"""Display layer: decimation plan parity, quantization, PNG/CSV export."""

import datetime

import numpy as np
import pytest

from pyspectrogram_tpu.display import (
    apply_lut,
    freq_crop_decimate,
    get_colormap,
    quantize_levels,
    quantize_on_device,
    save_psd_csv,
    save_sti_png,
    spectral_legacy_colors,
    sti_tile,
    viridis_colors,
)


def _reference_decimation_plan(freqs, cfrange, maxNfreqs):
    """Literal translation of the reference's plan for the test oracle
    (reference: drfview.py:1006-1023)."""
    keepvals = np.all(
        (np.greater_equal(freqs, 1e3 * cfrange[0]),
         np.less_equal(freqs, 1e3 * cfrange[1])), axis=0)
    kept = freqs[keepvals]
    inds = np.argwhere(keepvals)
    fscale = int(np.ceil(len(kept) / maxNfreqs))
    rel = range(int(np.floor(fscale / 2)), len(kept), fscale)
    return [inds[i][0] for i in rel], np.array([kept[i] for i in rel])


@pytest.mark.parametrize("maxn", [8, 100, 2 ** 15])
@pytest.mark.parametrize("frange", [(-1000, 1000), (-100, 250), (30, 31)])
def test_decimation_plan_matches_reference(maxn, frange):
    freqs = np.fft.fftshift(np.fft.fftfreq(4096, 1e-6))
    want_idx, want_f = _reference_decimation_plan(freqs, frange, maxn)
    got_idx, got_f = freq_crop_decimate(freqs, frange, maxn)
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_array_equal(got_f, want_f)
    assert len(got_f) <= maxn


def test_colormaps():
    v = viridis_colors()
    assert v.shape == (256, 3) and v.min() >= 0 and v.max() <= 1
    s = spectral_legacy_colors()
    assert s.shape == (500, 3)
    # dark-gray start, dark-red end
    assert np.allclose(s[0], s[0][0]) and s[-1][0] > s[-1][1]
    assert get_colormap("viridis", 500).shape == (500, 3)
    lv = quantize_levels((-110, -40), 256)
    assert lv[0] == -110 and lv[-1] == -40 and len(lv) == 256


def test_quantize_clamps_and_scales():
    sxx = np.array([[-200.0, -110.0, -75.0, -40.0, 0.0]], np.float32)
    q = quantize_on_device(sxx, (-110.0, -40.0), 256)
    assert q.dtype == np.uint8
    assert list(q[0]) == [0, 0, 128, 255, 255]
    rgba = apply_lut(q)
    assert rgba.shape == (1, 5, 4) and rgba[..., 3].min() == 255


def test_sti_tile_shapes():
    rng = np.random.default_rng(0)
    nfft, ntime = 512, 20
    sxx = rng.uniform(-120, -40, (nfft, ntime)).astype(np.float32)
    freqs = np.fft.fftshift(np.fft.fftfreq(nfft, 1e-6))
    rgba, plotf = sti_tile(sxx, freqs, (-110, -40), frange_khz=(-100, 100),
                           max_nfreqs=64)
    assert rgba.shape == (ntime, len(plotf), 4)
    assert len(plotf) <= 64
    assert np.all(np.abs(plotf) <= 100e3)


@pytest.mark.parametrize("renderer", ["pixels", "matplotlib"])
def test_save_sti_png(tmp_path, renderer):
    if renderer == "matplotlib":
        pytest.importorskip("matplotlib")
    rng = np.random.default_rng(1)
    nfft, ntime = 128, 16
    sxx = rng.uniform(-120, -40, (nfft, ntime))
    freqs = np.fft.fftshift(np.fft.fftfreq(nfft, 1e-5))
    t0 = datetime.datetime(2016, 1, 1)
    times = np.array([t0 + datetime.timedelta(seconds=i) for i in range(ntime)])
    out = save_sti_png(
        str(tmp_path / "w"), freqs, times, sxx, (-110.0, -40.0),
        freqrange_khz=(-40, 40),
        timerange=(times[2], times[-3]),
        renderer=renderer,
    )
    assert out.endswith(".png")
    from PIL import Image

    im = Image.open(out)
    assert im.size[0] > 0 and im.size[1] > 0


def test_save_psd_csv(tmp_path):
    freqs = np.linspace(-100, 100, 11)
    psd = np.linspace(-90, -50, 11)
    out = save_psd_csv(str(tmp_path / "psd"), freqs, psd)
    back = np.loadtxt(out, delimiter=",", skiprows=1)
    np.testing.assert_allclose(back[:, 0], freqs)
    np.testing.assert_allclose(back[:, 1], psd)


def test_apply_lut_long_ramp_reaches_top_color():
    """Ramps longer than 256 entries resample across the FULL span: the
    top quantization level renders the ramp's LAST color (slicing the
    head of the 500-entry ramp left half of it unreachable)."""
    cdata = spectral_legacy_colors()  # 500 entries
    q = np.array([[0, 255]], np.uint8)
    rgba = apply_lut(q, cdata)
    np.testing.assert_array_equal(rgba[0, 0, :3], np.round(cdata[0] * 255))
    np.testing.assert_array_equal(rgba[0, 1, :3], np.round(cdata[-1] * 255))


def test_sti_tile_long_colormap_full_span():
    cdata = spectral_legacy_colors()
    sxx = np.full((8, 4), -40.0, np.float32)  # everything at cmax
    freqs = np.fft.fftshift(np.fft.fftfreq(8, 1e-6))
    rgba, _ = sti_tile(sxx, freqs, (-110, -40), colors=cdata)
    np.testing.assert_array_equal(rgba[0, 0, :3], np.round(cdata[-1] * 255))


def test_quantize_reclim_shares_compiled_program():
    """quantize_on_device keys its compiled program on npoints only: a
    color-range change re-runs the SAME program with a new (2,) operand
    (a recompile costs seconds)."""
    from pyspectrogram_tpu.display.render import _make_quantize_fn

    sxx = np.linspace(-120, -30, 16, dtype=np.float32)[None]
    quantize_on_device(sxx, (-110.0, -40.0), 256)
    before = _make_quantize_fn.cache_info()
    q = quantize_on_device(sxx, (-90.0, -30.0), 256)
    after = _make_quantize_fn.cache_info()
    assert after.misses == before.misses  # re-clim: cache hit, no rebuild
    # and the re-clim values are still right
    want = np.clip(np.round((sxx - -90.0) * (255 / 60.0)), 0, 255)
    np.testing.assert_array_equal(q, want.astype(np.uint8))
