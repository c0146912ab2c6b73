"""Multi-device sharding on the 8-device virtual CPU mesh (SURVEY.md §4.4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from pyspectrogram_tpu.io.reader import RFDataset
from pyspectrogram_tpu.ops import stft
from pyspectrogram_tpu.parallel import (
    make_mesh,
    make_sharded_sti_fn,
    pad_starts,
)


def _buffer(nsamp, nsub, seed=0):
    """time-major packed (for the single-device oracle) + plane-major."""
    rng = np.random.default_rng(seed)
    packed = rng.standard_normal((nsamp, nsub, 2)).astype(np.float32)
    pm = np.ascontiguousarray(
        np.moveaxis(packed, 0, -1).reshape(nsub * 2, nsamp))
    return packed, pm


def test_mesh_shapes():
    assert make_mesh().devices.shape == (8, 1)
    assert make_mesh(time_parallel=4, chan_parallel=2).devices.shape == (4, 2)
    assert make_mesh(chan_parallel=2).devices.shape == (4, 2)
    with pytest.raises(ValueError):
        make_mesh(time_parallel=3)


def test_pad_starts():
    s = np.asarray([0, 10, 20], np.int32)
    padded, n = pad_starts(s, 4)
    assert n == 3 and list(padded) == [0, 10, 20, 20]
    same, n2 = pad_starts(padded, 4)
    assert n2 == 4 and same is padded


@pytest.mark.parametrize("tp,cp", [(8, 1), (4, 2), (2, 4)])
def test_sharded_matches_single_device(tp, cp):
    nfft, nint, ntime, nsub = 64, 2, 16, 4
    nsamp = nfft * nint * ntime + 32
    packed, pm = _buffer(nsamp, nsub)
    starts = np.linspace(0, nsamp - nfft * nint, ntime, dtype=np.int32)

    single = stft.make_sti_fn(nfft=nfft, nint=nint, mode="welch")
    want = single(jnp.asarray(packed), jnp.asarray(starts))

    mesh = make_mesh(time_parallel=tp, chan_parallel=cp)
    sharded = make_sharded_sti_fn(
        mesh, nfft=nfft, nint=nint, ntime_valid=ntime, mode="welch"
    )
    got = sharded(jnp.asarray(pm), jnp.asarray(starts))

    np.testing.assert_allclose(
        np.asarray(got["sxx_dbfs"]), np.asarray(want["sxx_dbfs"]), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(got["sxx_med_dbfs"]), np.asarray(want["sxx_med_dbfs"]),
        atol=2e-3,
    )


def test_sharded_with_padded_time_axis():
    """ntime not divisible by the time axis: padded columns must not bias
    the median."""
    nfft, ntime, nsub = 64, 13, 2
    nsamp = nfft * ntime + 200
    packed, pm = _buffer(nsamp, nsub, seed=3)
    starts = np.linspace(0, nsamp - nfft, ntime, dtype=np.int32)
    padded, nvalid = pad_starts(starts, 8)
    assert nvalid == 13 and len(padded) == 16

    single = stft.make_sti_fn(nfft=nfft)
    want = single(jnp.asarray(packed), jnp.asarray(starts))

    mesh = make_mesh()
    sharded = make_sharded_sti_fn(mesh, nfft=nfft, ntime_valid=nvalid)
    got = sharded(jnp.asarray(pm), jnp.asarray(padded))
    np.testing.assert_allclose(
        np.asarray(got["sxx_dbfs"])[:nvalid], np.asarray(want["sxx_dbfs"]),
        atol=2e-3,
    )
    np.testing.assert_allclose(
        np.asarray(got["sxx_med_dbfs"]), np.asarray(want["sxx_med_dbfs"]),
        atol=2e-3,
    )


def test_sharded_accepts_device_sharded_inputs():
    """Inputs pre-placed with the advertised shardings stay sharded."""
    nfft, ntime, nsub = 64, 16, 4
    nsamp = nfft * ntime
    packed, pm = _buffer(nsamp, nsub, seed=4)
    starts = np.linspace(0, nsamp - nfft, ntime, dtype=np.int32)
    mesh = make_mesh(time_parallel=4, chan_parallel=2)
    f = make_sharded_sti_fn(mesh, nfft=nfft, ntime_valid=ntime)
    s_sh, st_sh = f.input_shardings()
    samples_d = jax.device_put(jnp.asarray(pm), s_sh)
    starts_d = jax.device_put(jnp.asarray(starts), st_sh)
    out = f(samples_d, starts_d)
    assert out["sxx_dbfs"].sharding.spec == P("time", "chan")
    single = stft.make_sti_fn(nfft=nfft)
    want = single(jnp.asarray(packed), jnp.asarray(starts))
    np.testing.assert_allclose(
        np.asarray(out["sxx_dbfs"]), np.asarray(want["sxx_dbfs"]), atol=2e-3
    )


def test_sharded_ships_raw_int16_and_widens_on_device():
    """Raw int16 planes ship unconverted through the sharded path (half
    the transfer bytes, times one copy per replicated device) and widen
    per shard on device (VERDICT r2 weak #2)."""
    nfft, ntime, nsub = 64, 16, 2
    nsamp = nfft * ntime
    rng = np.random.default_rng(9)
    pm_i16 = rng.integers(-(1 << 12), 1 << 12,
                          size=(nsub * 2, nsamp)).astype(np.int16)
    starts = (np.arange(ntime) * nfft).astype(np.int32)
    ref = 2.0 ** 15.5  # the int16 dBFS rule (reference: drfProc.py:199-201)

    single = stft.make_sti_fn_pm(nfft=nfft, ref=ref)
    want = single(jnp.asarray(pm_i16), jnp.asarray(starts))

    mesh = make_mesh(time_parallel=4, chan_parallel=2)
    f = make_sharded_sti_fn(mesh, nfft=nfft, ntime_valid=ntime, ref=ref)
    s_sh, st_sh = f.input_shardings()
    samples_d = jax.device_put(jnp.asarray(pm_i16), s_sh)
    assert samples_d.dtype == jnp.int16  # raw across the boundary
    got = f(samples_d, jax.device_put(jnp.asarray(starts), st_sh))
    np.testing.assert_allclose(np.asarray(got["sxx_dbfs"]),
                               np.asarray(want["sxx_dbfs"]), atol=2e-3)
    np.testing.assert_allclose(np.asarray(got["sxx_med_dbfs"]),
                               np.asarray(want["sxx_med_dbfs"]), atol=2e-3)


def test_pipeline_sharded_int16_capture_matches_single_device(
        int16_capture):
    """Full pipeline over the int16 fixture: mesh result == single-chip
    result, with the device block still int16 end to end."""
    from pyspectrogram_tpu.models.sti import StiPipeline
    from pyspectrogram_tpu.utils.config import SpectrogramConfig

    top, meta = int16_capture
    ds1, ds2 = RFDataset(top), RFDataset(top)
    cfg = SpectrogramConfig(nfft=128, nint=2, ntime=16)
    want = StiPipeline(ds1, cfg).compute()
    mesh = make_mesh(time_parallel=8, chan_parallel=1)
    got = StiPipeline(ds2, cfg, mesh=mesh).compute()
    np.testing.assert_allclose(got.sxx_dbfs, want.sxx_dbfs, atol=2e-3)
    np.testing.assert_allclose(got.sxx_med_dbfs, want.sxx_med_dbfs,
                               atol=2e-3)


@pytest.mark.parametrize("tp,cp", [(8, 1), (4, 2)])
@pytest.mark.parametrize("mode", ["welch", "parity"])
def test_contiguous_sharded_matches_gathered(tp, cp, mode):
    """contiguous=True (buffer sharded over BOTH axes, starts rebased per
    shard) equals the replicated gathered tier on the packed layout."""
    nfft, nint, ntime, nsub = 64, 2, 16, 4
    frame_len = nfft * nint
    nsamp = frame_len * ntime
    packed, pm = _buffer(nsamp, nsub, seed=11)
    starts = (np.arange(ntime) * frame_len).astype(np.int32)
    mesh = make_mesh(time_parallel=tp, chan_parallel=cp)

    gathered = make_sharded_sti_fn(
        mesh, nfft=nfft, nint=nint, ntime_valid=ntime, mode=mode)
    cont = make_sharded_sti_fn(
        mesh, nfft=nfft, nint=nint, ntime_valid=ntime, mode=mode,
        contiguous=True)
    # the buffer itself shards over time — no replica per time-axis row
    assert cont.input_shardings()[0].spec == P("chan", "time")

    want = gathered(jnp.asarray(pm), jnp.asarray(starts))
    got = cont(jax.device_put(jnp.asarray(pm), cont.input_shardings()[0]),
               jnp.asarray(starts))
    np.testing.assert_allclose(np.asarray(got["sxx_dbfs"]),
                               np.asarray(want["sxx_dbfs"]), atol=2e-3)
    np.testing.assert_allclose(np.asarray(got["sxx_med_dbfs"]),
                               np.asarray(want["sxx_med_dbfs"]), atol=2e-3)


def test_contiguous_sharded_pad_block():
    """pad_contiguous_block extends the ladder into zero samples; padded
    columns shard cleanly and stay out of the median."""
    from pyspectrogram_tpu.parallel.mesh import pad_contiguous_block

    nfft, ntime, nsub = 64, 13, 2
    nsamp = nfft * ntime
    packed, pm = _buffer(nsamp, nsub, seed=12)
    starts = (np.arange(ntime) * nfft).astype(np.int32)

    single = stft.make_sti_fn(nfft=nfft)
    want = single(jnp.asarray(packed), jnp.asarray(starts))

    pm_p, starts_p, nvalid = pad_contiguous_block(pm, ntime, nfft, 8)
    assert nvalid == 13 and len(starts_p) == 16
    assert pm_p.shape == (nsub * 2, 16 * nfft)

    mesh = make_mesh()
    f = make_sharded_sti_fn(mesh, nfft=nfft, ntime_valid=nvalid,
                            contiguous=True)
    got = f(jax.device_put(jnp.asarray(pm_p), f.input_shardings()[0]),
            jnp.asarray(starts_p))
    np.testing.assert_allclose(
        np.asarray(got["sxx_dbfs"])[:nvalid], np.asarray(want["sxx_dbfs"]),
        atol=2e-3)
    np.testing.assert_allclose(np.asarray(got["sxx_med_dbfs"]),
                               np.asarray(want["sxx_med_dbfs"]), atol=2e-3)


def test_sharded_tile_epilogue_matches_host():
    """tile= fuses the per-shard uint8 quantization into the sharded
    program; the color range is a runtime operand (re-clim == same
    program, different qparams)."""
    from pyspectrogram_tpu.display.render import quantize_on_device
    from pyspectrogram_tpu.display.tile import make_tile_spec

    nfft, ntime, nsub = 64, 16, 2
    nsamp = nfft * ntime
    packed, pm = _buffer(nsamp, nsub, seed=14)
    starts = (np.arange(ntime) * nfft).astype(np.int32)
    freqs = stft.shifted_freqs(nfft, 100_000)
    crange = (-110.0, -40.0)
    spec = make_tile_spec(freqs, (-30.0, 30.0), crange, max_nfreqs=23)

    single = stft.make_sti_fn(nfft=nfft)
    want_db = np.asarray(
        single(jnp.asarray(packed), jnp.asarray(starts))["sxx_dbfs"])
    # (ntime, nsub, nfft) -> tile layout (ntime, nsub, plot_n)
    want_tm = want_db[..., spec.plot_indices]

    mesh = make_mesh(time_parallel=4, chan_parallel=2)
    f = make_sharded_sti_fn(mesh, nfft=nfft, ntime_valid=ntime,
                            contiguous=True, tile=spec.crop_key())
    sh = f.input_shardings()
    assert len(sh) == 3  # samples, starts, qparams
    args = (jax.device_put(jnp.asarray(pm), sh[0]), jnp.asarray(starts))
    out = f(*args, jax.device_put(jnp.asarray(spec.qparams), sh[2]))
    assert "sxx_dbfs" not in out  # floats never leave the shards
    np.testing.assert_array_equal(
        np.asarray(out["tile"]), quantize_on_device(want_tm, crange, 256))
    # re-clim through the SAME compiled fn: only the operand changes
    crange2 = (-90.0, -10.0)
    spec2 = make_tile_spec(freqs, (-30.0, 30.0), crange2, max_nfreqs=23)
    out2 = f(*args, jax.device_put(jnp.asarray(spec2.qparams), sh[2]))
    np.testing.assert_array_equal(
        np.asarray(out2["tile"]), quantize_on_device(want_tm, crange2, 256))


def test_sharded_factory_canonicalizes_tile_key():
    """make_sharded_sti_fn canonicalizes the tile's color range BEFORE
    the compile cache: specs differing only in cmin/cmax return the same
    compiled fn whether or not the caller passed crop_key() (a re-clim
    must never rebuild the shard_map program)."""
    from pyspectrogram_tpu.display.tile import make_tile_spec

    mesh = make_mesh()
    freqs = stft.shifted_freqs(256, 1e6)
    s1 = make_tile_spec(freqs, (-200.0, 200.0), (-80.0, -20.0))
    s2 = make_tile_spec(freqs, (-200.0, 200.0), (-95.0, -35.0))
    a = make_sharded_sti_fn(mesh, nfft=256, ntime_valid=8, tile=s1)
    b = make_sharded_sti_fn(mesh, nfft=256, ntime_valid=8, tile=s2)
    c = make_sharded_sti_fn(mesh, nfft=256, ntime_valid=8,
                            tile=s1.crop_key())
    assert a is b and b is c


@pytest.mark.parametrize("contiguous", [True, False])
def test_sharded_matches_oracle(contiguous):
    """The sharded tier's linear powers equal the NumPy oracle directly
    (not only the single-device program), contiguous and gathered."""
    from pyspectrogram_tpu.ops import reference as oracle

    nfft, nint, ntime, nsub = 256, 2, 16, 2
    frame_len = nfft * nint
    nsamp = frame_len * ntime + (0 if contiguous else 100)
    packed, pm = _buffer(nsamp, nsub, seed=13)
    starts = (np.arange(ntime) * frame_len).astype(np.int32)
    if not contiguous:
        starts = starts + 37
    mesh = make_mesh(time_parallel=4, chan_parallel=2)
    fn = make_sharded_sti_fn(mesh, nfft=nfft, nint=nint, ntime_valid=ntime,
                             contiguous=contiguous)
    sh = fn.input_shardings()
    out = fn(jax.device_put(jnp.asarray(pm), sh[0]),
             jax.device_put(jnp.asarray(starts), sh[1]))
    x = packed[..., 0].astype(np.float64) + 1j * packed[..., 1]
    block = np.stack([x[s:s + frame_len] for s in starts], axis=1)
    want = oracle.to_dbfs(oracle.sti_psd(block, nfft, nint=nint,
                                         mode="welch"))
    np.testing.assert_allclose(
        stft.to_reference_layout(np.asarray(out["sxx_dbfs"])), want,
        atol=5e-3)


def test_contiguous_sharded_int16_planes_match_float():
    """Raw int16 planes through the contiguous sharded tier widen per
    shard on device and equal the same samples shipped as float32."""
    nfft, ntime, nsub = 256, 16, 2
    rng = np.random.default_rng(3)
    pm16 = rng.integers(-(1 << 12), 1 << 12,
                        size=(nsub * 2, ntime * nfft)).astype(np.int16)
    starts = (np.arange(ntime) * nfft).astype(np.int32)
    ref = 2.0 ** 15.5  # int16 dBFS rule (reference: drfProc.py:199-201)
    mesh = make_mesh(time_parallel=8, chan_parallel=1)
    fn = make_sharded_sti_fn(mesh, nfft=nfft, ntime_valid=ntime, ref=ref,
                             contiguous=True)
    sh = fn.input_shardings()[0]
    a = fn(jax.device_put(jnp.asarray(pm16), sh), jnp.asarray(starts))
    b = fn(jax.device_put(jnp.asarray(pm16.astype(np.float32)), sh),
           jnp.asarray(starts))
    np.testing.assert_array_equal(np.asarray(a["sxx_dbfs"]),
                                  np.asarray(b["sxx_dbfs"]))


@pytest.mark.parametrize("nvalid", [13, 16])  # odd (exact) and even (mean)
def test_median_psum_matches_numpy(nvalid):
    """The psum'd bisection median (huge-ntime tier) equals np.median
    over the valid prefix, padding masked, odd and even counts."""
    from jax import shard_map

    from pyspectrogram_tpu.ops.stft import median_over_time_psum

    mesh = make_mesh()  # (8, 1)
    rng = np.random.default_rng(5)
    p = rng.standard_normal((16, 3, 64)).astype(np.float32) ** 2
    p[nvalid:] = 1e12  # poisoned padding must not bias the median

    fn = jax.jit(shard_map(
        lambda x: median_over_time_psum(x, "time", nvalid),
        mesh=mesh, in_specs=P("time", None, None),
        out_specs=P(),  # replicated result
    ))
    got = np.asarray(fn(jnp.asarray(p)))
    np.testing.assert_array_equal(got, np.median(p[:nvalid], axis=0))


def test_sharded_median_psum_tier_matches_gathered(monkeypatch):
    """Forcing the huge-ntime psum median (GATHERED_MEDIAN_MAX_BYTES = 0)
    must reproduce the gathered tier's result exactly through the full
    sharded STI program, including time-axis padding."""
    from pyspectrogram_tpu.parallel import sharded as sharded_mod

    nfft, ntime, nsub = 64, 13, 2
    nsamp = nfft * ntime + 200
    packed, pm = _buffer(nsamp, nsub, seed=9)
    starts = np.linspace(0, nsamp - nfft, ntime, dtype=np.int32)
    padded, nvalid = pad_starts(starts, 8)

    mesh = make_mesh()
    want = make_sharded_sti_fn(mesh, nfft=nfft, ntime_valid=nvalid)(
        jnp.asarray(pm), jnp.asarray(padded))
    monkeypatch.setattr(sharded_mod, "GATHERED_MEDIAN_MAX_BYTES", 0)
    sharded_mod._make_sharded_sti_fn.cache_clear()
    got = make_sharded_sti_fn(mesh, nfft=nfft, ntime_valid=nvalid)(
        jnp.asarray(pm), jnp.asarray(padded))
    sharded_mod._make_sharded_sti_fn.cache_clear()
    np.testing.assert_array_equal(np.asarray(got["sxx_med_dbfs"]),
                                  np.asarray(want["sxx_med_dbfs"]))
    np.testing.assert_array_equal(np.asarray(got["sxx_dbfs"]),
                                  np.asarray(want["sxx_dbfs"]))


def test_sharded_tile_mode_requires_qparams():
    """Omitting the color-range operand in tile mode names the contract
    instead of dying in a shard_map pytree mismatch."""
    from pyspectrogram_tpu.display.tile import make_tile_spec

    nfft, ntime, nsub = 64, 16, 2
    nsamp = nfft * ntime
    _, pm = _buffer(nsamp, nsub, seed=1)
    starts = (np.arange(ntime) * nfft).astype(np.int32)
    spec = make_tile_spec(np.fft.fftshift(np.fft.fftfreq(nfft, 1e-6)),
                          (-250.0, 250.0), (-110.0, -40.0), 64)
    fn = make_sharded_sti_fn(make_mesh(), nfft=nfft, ntime_valid=ntime,
                             tile=spec)
    with pytest.raises(ValueError, match="color-range operand"):
        fn(jnp.asarray(pm), jnp.asarray(starts))
    out = fn(jnp.asarray(pm), jnp.asarray(starts), jnp.asarray(spec.qparams))
    assert np.asarray(out["tile"]).dtype == np.uint8


@pytest.mark.parametrize("seed", [2, 17, 29, 41])
def test_randomized_sharded_matches_single_chip(seed):
    """Seeded random-config differential sweep for the sharded tier:
    random (nfft, nint, mode, window, mesh shape, contiguous layout,
    padded ntime) through make_sharded_sti_fn must equal the single-chip
    plane-major program — pinned mesh tests cannot see interactions a
    random draw can (e.g. 2D mesh x parity x non-divisible ntime)."""
    from pyspectrogram_tpu.ops.stft import make_sti_fn_pm

    rng = np.random.default_rng(seed)
    nfft = int(rng.choice([32, 64, 128]))
    nint = int(rng.choice([1, 2, 3]))
    mode = str(rng.choice(["welch", "parity"]))
    window = ("kaiser", 1.7) if rng.random() < 0.5 else "hann"
    chan_par = int(rng.choice([1, 2]))
    nsub = int(rng.choice([1, 2])) * chan_par
    contiguous = bool(rng.random() < 0.5)
    ntime = int(rng.integers(3, 18))
    mesh = make_mesh(time_parallel=8 // chan_par, chan_parallel=chan_par)

    frame_len = nfft * nint
    if contiguous:
        # the contiguous layout packs column t's frame at t*frame_len
        starts = (np.arange(ntime) * frame_len).astype(np.int32)
        nsamp = ntime * frame_len
    else:
        nsamp = ntime * frame_len + int(rng.integers(0, frame_len))
        starts = np.sort(rng.choice(
            nsamp - frame_len + 1, size=ntime, replace=False)
        ).astype(np.int32)
    packed, pm = _buffer(nsamp, nsub, seed=seed + 7)
    if contiguous:
        # the contiguous tier shards the buffer itself over time, so the
        # padding must extend the column ladder (mesh.pad_contiguous_block),
        # not repeat the last start the way the gathered tier pads
        from pyspectrogram_tpu.parallel.mesh import pad_contiguous_block

        pm_dev, padded, nvalid = pad_contiguous_block(
            pm, ntime, frame_len, mesh.shape["time"])
    else:
        pm_dev, (padded, nvalid) = pm, pad_starts(starts,
                                                  mesh.shape["time"])

    fn = make_sharded_sti_fn(mesh, nfft=nfft, nint=nint, mode=mode,
                             window=window, ntime_valid=nvalid,
                             contiguous=contiguous)
    s_sh, _ = fn.input_shardings()
    got = fn(jax.device_put(jnp.asarray(pm_dev), s_sh), jnp.asarray(padded))

    want = make_sti_fn_pm(nfft=nfft, nint=nint, mode=mode, window=window)(
        jnp.asarray(pm), jnp.asarray(starts))
    np.testing.assert_allclose(
        np.asarray(got["sxx_dbfs"])[:nvalid],
        np.asarray(want["sxx_dbfs"]), atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(got["sxx_med_dbfs"]), np.asarray(want["sxx_med_dbfs"]),
        atol=1e-4)
