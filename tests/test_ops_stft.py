"""JAX STI core vs the NumPy oracle (golden-value tests, SURVEY.md §4.1)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pyspectrogram_tpu.ops import reference as oracle
from pyspectrogram_tpu.ops import stft


def _random_buffer(nsamp, nsub, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nsamp, nsub)).astype(np.float32)
            + 1j * rng.standard_normal((nsamp, nsub)).astype(np.float32)
            ).astype(np.complex64)


def _oracle_outputs(samples, starts, nfft, nint, mode, eps=1e-15):
    """Build the (nfft*nint, ntime, nsub) block the reference layout uses
    and run the oracle on it."""
    frame_len = nfft * nint
    block = np.stack([samples[s : s + frame_len] for s in starts], axis=1)
    sxx = oracle.sti_psd(block, nfft, nint=nint, mode=mode)  # (nfft,ntime,nsub)
    med = np.median(sxx, axis=1)
    return oracle.to_dbfs(sxx, eps), oracle.to_dbfs(med, eps)


@pytest.mark.parametrize("mode,nint", [("parity", 1), ("parity", 3), ("welch", 4)])
def test_sti_matches_oracle(mode, nint):
    nfft, ntime, nsub = 128, 9, 2
    samples = _random_buffer(nfft * nint * ntime + 64, nsub)
    starts = np.linspace(0, len(samples) - nfft * nint, ntime, dtype=int)

    fn = stft.make_sti_fn(nfft=nfft, nint=nint, mode=mode)
    out = fn(jnp.asarray(samples), jnp.asarray(starts, jnp.int32))

    got_sxx = stft.to_reference_layout(out["sxx_dbfs"])      # (nfft,ntime,nsub)
    got_med = np.moveaxis(np.asarray(out["sxx_med_dbfs"]), -1, 0)  # (nfft,nsub)
    want_sxx, want_med = _oracle_outputs(samples.astype(np.complex128), starts,
                                         nfft, nint, mode)
    # float32 device vs float64 oracle: dB-domain agreement
    np.testing.assert_allclose(got_sxx, want_sxx, atol=5e-3, rtol=0)
    np.testing.assert_allclose(got_med, want_med, atol=5e-3, rtol=0)


def test_sti_float64_tight_match():
    """complex128 on CPU must agree with the oracle to near machine eps."""
    with jax.enable_x64(True):
        nfft, nint, ntime, nsub = 64, 2, 7, 1
        samples = _random_buffer(nfft * nint * ntime, nsub, seed=5).astype(
            np.complex128
        )
        starts = np.linspace(0, len(samples) - nfft * nint, ntime, dtype=int)
        fn = stft.make_sti_fn(nfft=nfft, nint=nint, mode="welch",
                              compute_dtype=jnp.complex128)
        out = fn(jnp.asarray(samples), jnp.asarray(starts, jnp.int64))
        want_sxx, want_med = _oracle_outputs(samples, starts, nfft, nint, "welch")
        np.testing.assert_allclose(
            stft.to_reference_layout(out["sxx_dbfs"]), want_sxx, rtol=1e-12
        )
        np.testing.assert_allclose(
            np.moveaxis(np.asarray(out["sxx_med_dbfs"]), -1, 0), want_med,
            rtol=1e-12,
        )


def test_packed_int16_input_normalization():
    """Raw int16 r/i planes with ref folded into the power scale must match
    normalizing on the host first (reference normalizes x/ref before the
    FFT, drfProc.py:129; scaling commutes through to power)."""
    rng = np.random.default_rng(7)
    nfft, ntime = 128, 5
    nsamp = nfft * ntime
    raw = rng.integers(-(2 ** 14), 2 ** 14, size=(nsamp, 1, 2)).astype(np.int16)
    ref_level = 2.0 ** 15.5
    starts = np.arange(ntime, dtype=np.int32) * nfft

    fn_raw = stft.make_sti_fn(nfft=nfft, ref=ref_level)
    out_raw = fn_raw(jnp.asarray(raw), jnp.asarray(starts))

    complex_host = (raw[..., 0].astype(np.float64)
                    + 1j * raw[..., 1].astype(np.float64)) / ref_level
    want_sxx, want_med = _oracle_outputs(complex_host, starts, nfft, 1, "welch")
    np.testing.assert_allclose(
        stft.to_reference_layout(out_raw["sxx_dbfs"]), want_sxx, atol=5e-3
    )


def test_gather_frames_layout():
    samples = jnp.arange(40, dtype=jnp.float32).reshape(20, 2)
    starts = jnp.asarray([0, 5, 12], jnp.int32)
    frames = stft.gather_frames(samples, starts, 4)
    assert frames.shape == (3, 2, 4)
    np.testing.assert_array_equal(frames[1, 0], [10, 12, 14, 16])
    np.testing.assert_array_equal(frames[2, 1], [25, 27, 29, 31])


def test_tone_peak_on_device():
    """End-to-end sanity: exact-bin tone lands all power in its bin."""
    nfft, sr, k = 256, 1e6, -40
    n = np.arange(nfft * 4)
    x = np.exp(2j * np.pi * k * n / nfft).astype(np.complex64)[:, None]
    starts = np.asarray([0, nfft, 2 * nfft], np.int32)
    fn = stft.make_sti_fn(nfft=nfft, window="boxcar")
    out = fn(jnp.asarray(x), jnp.asarray(starts))
    freqs = stft.shifted_freqs(nfft, sr)
    sxx = np.asarray(out["sxx_dbfs"])[0, 0]
    peak = int(np.argmax(sxx))
    assert freqs[peak] == pytest.approx(k * sr / nfft)
    assert sxx[peak] == pytest.approx(0.0, abs=1e-3)  # 0 dBFS


def test_welch_reduces_variance():
    """True nint averaging must reduce PSD variance on white noise —
    the behavioral fix over the reference's silent truncation."""
    rng = np.random.default_rng(11)
    nfft, nint, ntime = 64, 16, 4
    nsamp = nfft * nint * ntime
    x = ((rng.standard_normal((nsamp, 1)) + 1j * rng.standard_normal((nsamp, 1)))
         / np.sqrt(2)).astype(np.complex64)
    starts = np.arange(ntime, dtype=np.int32) * nfft * nint
    par = stft.make_sti_fn(nfft=nfft, nint=nint, mode="parity", return_linear=True)
    wel = stft.make_sti_fn(nfft=nfft, nint=nint, mode="welch", return_linear=True)
    p = np.asarray(par(jnp.asarray(x), jnp.asarray(starts))["sxx"])
    w = np.asarray(wel(jnp.asarray(x), jnp.asarray(starts))["sxx"])
    assert w.std() < p.std() / 2.5  # ~sqrt(16)=4x in expectation


def test_reference_ntime_ceiling_structurally_supported():
    """The reference's ntime spinbox tops out at 100,000
    (drfview.py:501); a request at that ceiling must flow through the
    pipeline core + exact median without special-casing (the 33-step
    bisection tier)."""
    nfft, ntime = 256, 100_000
    rng = np.random.default_rng(0)
    pm = (0.01 * rng.standard_normal((2, nfft * ntime))).astype(np.float32)
    starts = (np.arange(ntime) * nfft).astype(np.int32)
    out = stft.make_sti_fn_pm(nfft=nfft, contiguous=True)(
        jnp.asarray(pm), jnp.asarray(starts))
    sxx = np.asarray(out["sxx_dbfs"])
    assert sxx.shape == (ntime, 1, nfft)
    want = np.median(10 ** (sxx[:, 0, :] / 10), axis=0)
    got = 10 ** (np.asarray(out["sxx_med_dbfs"])[0] / 10)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_reference_nint_ceiling_structurally_supported():
    """The reference's nint spinbox tops out at 100,000 (drfview.py:489);
    true-welch averaging at that ceiling must run and actually average:
    white noise over 1e5 segments leaves a near-flat PSD."""
    nfft, nint, ntime = 256, 100_000, 2
    rng = np.random.default_rng(0)
    pm = (0.01 * rng.standard_normal((2, nfft * nint * ntime))).astype(
        np.float32)
    starts = (np.arange(ntime) * nfft * nint).astype(np.int32)
    out = stft.make_sti_fn_pm(nfft=nfft, nint=nint, contiguous=True)(
        jnp.asarray(pm), jnp.asarray(starts))
    sxx = np.asarray(out["sxx_dbfs"])
    assert np.isfinite(sxx).all()
    assert sxx[0, 0].std() < 0.1  # ~0.013 dB measured; 1 seg is ~5.6 dB


@pytest.mark.parametrize("seed", [7, 19, 23])
def test_randomized_config_matches_oracle(seed):
    """Seeded random-config differential sweep: random (nfft, nint,
    ntime, nsub, mode, window) with random NON-CONTIGUOUS frame starts
    through make_sti_fn_pm must match the numpy oracle — the pinned-size
    tests cannot see interactions a random draw can (e.g. non-pow2 nfft
    x odd nint x hann)."""
    from pyspectrogram_tpu.ops import reference as oracle

    rng = np.random.default_rng(seed)
    nfft = int(rng.choice([32, 96, 128, 320, 512]))
    nint = int(rng.choice([1, 2, 3, 5]))
    ntime = int(rng.choice([2, 5, 13]))
    nsub = int(rng.choice([1, 3]))
    mode = str(rng.choice(["welch", "parity"]))
    window = ("kaiser", 1.7) if rng.random() < 0.5 else "hann"
    frame_len = nfft * nint
    nsamp = frame_len * ntime + int(rng.integers(0, frame_len))
    x = (rng.standard_normal((nsamp, nsub))
         + 1j * rng.standard_normal((nsamp, nsub))).astype(np.complex64)
    starts = np.sort(rng.choice(nsamp - frame_len + 1, size=ntime,
                                replace=False)).astype(np.int64)
    block = np.stack([x[s:s + frame_len] for s in starts], axis=1)
    _, sxx, med = oracle.sti_proc(block, 1e6, nfft, nint=nint, mode=mode,
                                  window=window)

    pm = np.empty((nsub * 2, nsamp), np.float32)
    pm[0::2] = x.real.T
    pm[1::2] = x.imag.T
    out = stft.make_sti_fn_pm(nfft=nfft, nint=nint, mode=mode,
                              window=window)(
        jnp.asarray(pm), jnp.asarray(starts.astype(np.int32)))
    got = stft.to_reference_layout(np.asarray(out["sxx_dbfs"]))
    np.testing.assert_allclose(got, oracle.to_dbfs(sxx), atol=0.05)
    np.testing.assert_allclose(
        np.moveaxis(np.asarray(out["sxx_med_dbfs"]), -1, 0),
        oracle.to_dbfs(med), atol=0.05)


def _inputs(nfft, nint, ntime, nsub, seed=0):
    rng = np.random.default_rng(seed)
    nsamp = nfft * nint * ntime + 64
    packed = rng.standard_normal((nsamp, nsub, 2)).astype(np.float32)
    starts = np.linspace(0, nsamp - nfft * nint, ntime).astype(np.int32)
    return packed, starts


def test_gemm_fft_factorization_exact():
    from pyspectrogram_tpu.kernels.gemm_fft import gemm_fft_numpy, make_plan

    rng = np.random.default_rng(1)
    for nfft in (256, 1024, 4096):
        x = rng.standard_normal((2, nfft)) + 1j * rng.standard_normal((2, nfft))
        Xr, Xi = gemm_fft_numpy(x.real, x.imag, make_plan(nfft, np.float64))
        want = np.fft.fft(x, axis=-1)
        np.testing.assert_allclose(Xr + 1j * Xi, want, rtol=1e-11, atol=1e-9)


def test_make_sti_fn_pm_layouts_agree():
    """Plane-major factory (XLA impl) == time-major factory on the same
    logical samples."""
    nfft, nint, ntime, nsub = 128, 2, 5, 3
    packed, starts = _inputs(nfft, nint, ntime, nsub, seed=4)
    tm = stft.make_sti_fn(nfft=nfft, nint=nint)(
        jnp.asarray(packed), jnp.asarray(starts))
    pm = stft.make_sti_fn_pm(nfft=nfft, nint=nint, fft_impl="xla")(
        jnp.asarray(stft.to_plane_major(packed)), jnp.asarray(starts))
    np.testing.assert_allclose(np.asarray(pm["sxx_dbfs"]),
                               np.asarray(tm["sxx_dbfs"]), atol=1e-4)
    np.testing.assert_allclose(np.asarray(pm["sxx_med_dbfs"]),
                               np.asarray(tm["sxx_med_dbfs"]), atol=1e-4)


def test_make_sti_fn_pm_int16_input():
    rng = np.random.default_rng(5)
    nfft, ntime = 128, 4
    pm16 = rng.integers(-2 ** 14, 2 ** 14, (2, nfft * ntime)).astype(np.int16)
    starts = (np.arange(ntime) * nfft).astype(np.int32)
    ref = 2.0 ** 15.5
    out16 = stft.make_sti_fn_pm(nfft=nfft, ref=ref, fft_impl="xla")(
        jnp.asarray(pm16), jnp.asarray(starts))
    outf = stft.make_sti_fn_pm(nfft=nfft, ref=ref, fft_impl="xla")(
        jnp.asarray(pm16.astype(np.float32)), jnp.asarray(starts))
    np.testing.assert_allclose(np.asarray(out16["sxx_dbfs"]),
                               np.asarray(outf["sxx_dbfs"]), atol=1e-5)


def test_make_sti_fn_pm_minmax_summary():
    rng = np.random.default_rng(8)
    nfft, ntime = 128, 6
    pm = rng.standard_normal((2, nfft * ntime)).astype(np.float32)
    starts = (np.arange(ntime) * nfft).astype(np.int32)
    out = stft.make_sti_fn_pm(nfft=nfft, fft_impl="xla", return_minmax=True,
                              return_linear=True)(
        jnp.asarray(pm), jnp.asarray(starts))
    p = np.asarray(out["sxx"])
    np.testing.assert_allclose(
        np.asarray(out["sxx_min_dbfs"]),
        10 * np.log10(p.min(axis=0) + 1e-15), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(out["sxx_max_dbfs"]),
        10 * np.log10(p.max(axis=0) + 1e-15), rtol=1e-6)


def _pm_oracle_linear(pm, starts, nfft, nint, mode, ref=1.0):
    """NumPy oracle (ops.reference) on plane-major planes -> (ntime, nsub,
    nfft) linear power, the device layout."""
    x = (pm[0::2].astype(np.float64) + 1j * pm[1::2].astype(np.float64)).T
    frame_len = nfft * nint
    block = np.stack([x[s:s + frame_len] for s in starts], axis=1) / ref
    return np.moveaxis(oracle.sti_psd(block, nfft, nint=nint, mode=mode),
                       0, -1)


def _plain_case(nfft, nint, mode, contiguous, nsub=2, ntime=5, seed=0,
                dtype=np.float32):
    rng = np.random.default_rng(seed)
    frame_len = nfft * nint
    if contiguous:
        nsamp = frame_len * ntime
        starts = (np.arange(ntime) * frame_len).astype(np.int32)
    else:
        nsamp = frame_len * ntime + 257
        starts = np.sort(rng.choice(nsamp - frame_len + 1, size=ntime,
                                    replace=False)).astype(np.int32)
    if dtype == np.int16:
        pm = rng.integers(-2 ** 14, 2 ** 14, (nsub * 2, nsamp)).astype(
            np.int16)
    else:
        pm = rng.standard_normal((nsub * 2, nsamp)).astype(np.float32)
    return pm, starts


@pytest.mark.parametrize("contiguous", [True, False])
@pytest.mark.parametrize("mode,nint", [("welch", 1), ("welch", 3),
                                       ("parity", 1), ("parity", 3)])
def test_plain_pm_path_matches_oracle(mode, nint, contiguous):
    """The production plane-major program (XLA FFT body) against the
    NumPy oracle: both modes, single and multi-segment, contiguous
    ladder and arbitrary gathered starts."""
    nfft = 256
    pm, starts = _plain_case(nfft, nint, mode, contiguous)
    out = stft.make_sti_fn_pm(nfft=nfft, nint=nint, mode=mode,
                              contiguous=contiguous, return_linear=True)(
        jnp.asarray(pm), jnp.asarray(starts))
    want = _pm_oracle_linear(pm, starts, nfft, nint, mode)
    np.testing.assert_allclose(np.asarray(out["sxx"]), want, rtol=2e-4,
                               atol=1e-7)
    np.testing.assert_array_equal(
        np.asarray(out["sxx_med"]),
        np.median(np.asarray(out["sxx"]), axis=0).astype(np.float32))


@pytest.mark.parametrize("nfft", [256, 1024, 4096, 65536, 262144])
def test_plain_pm_path_matches_oracle_nfft_sweep(nfft):
    """The same body from the small display FFTs up to 2^18 (the range
    the removed big-transform kernels used to cover): welch nint 2."""
    nint, ntime = 2, max(1, min(4, (1 << 18) // nfft))
    pm, starts = _plain_case(nfft, nint, "welch", True, nsub=1, ntime=ntime,
                             seed=nfft % 97)
    out = stft.make_sti_fn_pm(nfft=nfft, nint=nint, contiguous=True,
                              return_linear=True)(
        jnp.asarray(pm), jnp.asarray(starts))
    want = _pm_oracle_linear(pm, starts, nfft, nint, "welch")
    np.testing.assert_allclose(np.asarray(out["sxx"]), want, rtol=2e-3,
                               atol=1e-7)


@pytest.mark.parametrize("contiguous", [True, False])
def test_plain_pm_path_int16_with_ref_matches_oracle(contiguous):
    """Raw int16 planes widen on device and the full-scale reference
    rides the power scale: equal to normalizing on the host first."""
    ref = 2.0 ** 15.5
    nfft, nint = 512, 2
    pm, starts = _plain_case(nfft, nint, "welch", contiguous, dtype=np.int16)
    out = stft.make_sti_fn_pm(nfft=nfft, nint=nint, ref=ref,
                              contiguous=contiguous, return_linear=True)(
        jnp.asarray(pm), jnp.asarray(starts))
    want = _pm_oracle_linear(pm, starts, nfft, nint, "welch", ref=ref)
    np.testing.assert_allclose(np.asarray(out["sxx"]), want, rtol=2e-4,
                               atol=1e-12)


def test_plain_pm_path_ref_scaling():
    """ref scales linear power by exactly 1/ref^2."""
    nfft = 256
    pm, starts = _plain_case(nfft, 1, "welch", True, seed=3)
    ref = 2.0 ** 15.5
    a = stft.make_sti_fn_pm(nfft=nfft, ref=ref, return_linear=True)(
        jnp.asarray(pm), jnp.asarray(starts))["sxx"]
    b = stft.make_sti_fn_pm(nfft=nfft, return_linear=True)(
        jnp.asarray(pm), jnp.asarray(starts))["sxx"]
    np.testing.assert_allclose(np.asarray(a), np.asarray(b) / ref ** 2,
                               rtol=1e-6)


def test_plain_pm_path_tile_mode_matches_float_path():
    """Display-tile mode quantizes the same spectra the float path emits."""
    from pyspectrogram_tpu.display.tile import make_tile_spec, tile_from_db

    nfft, sr = 1024, 1e6
    pm, starts = _plain_case(nfft, 1, "welch", True, ntime=6, seed=9)
    freqs = stft.shifted_freqs(nfft, sr)
    spec = make_tile_spec(freqs, (-400.0, 400.0), (-30.0, 10.0))
    f = stft.make_sti_fn_pm(nfft=nfft, contiguous=True)(
        jnp.asarray(pm), jnp.asarray(starts))
    t = stft.make_sti_fn_pm(nfft=nfft, contiguous=True, tile=spec)(
        jnp.asarray(pm), jnp.asarray(starts))
    want = tile_from_db(np.asarray(f["sxx_dbfs"]), spec)
    got = np.asarray(t["tile"])
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("factory", ["single", "sharded_body", "batched"])
def test_fft_impl_pallas_raises(factory):
    """The Mosaic kernels are gone: an explicit fft_impl="pallas" is an
    error at build time on every entry point, never a silent fallback."""
    from pyspectrogram_tpu.models.batch import make_batched_sti_fn_pm
    from pyspectrogram_tpu.parallel.sharded import make_local_sti

    build = {
        "single": lambda: stft.make_sti_fn_pm(nfft=256, fft_impl="pallas"),
        "sharded_body": lambda: make_local_sti(nfft=256, fft_impl="pallas"),
        "batched": lambda: make_batched_sti_fn_pm(nfft=256, ntime=4,
                                                  fft_impl="pallas"),
    }[factory]
    with pytest.raises(ValueError, match="fft_impl"):
        build()


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_fft_impl_auto_and_xla_build_the_same_program(impl):
    nfft = 256
    pm, starts = _plain_case(nfft, 1, "welch", True, seed=2)
    a = stft.make_sti_fn_pm(nfft=nfft, fft_impl=impl)(
        jnp.asarray(pm), jnp.asarray(starts))
    b = stft.make_sti_fn_pm(nfft=nfft, fft_impl="xla")(
        jnp.asarray(pm), jnp.asarray(starts))
    np.testing.assert_array_equal(np.asarray(a["sxx_dbfs"]),
                                  np.asarray(b["sxx_dbfs"]))
