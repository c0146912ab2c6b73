#!/usr/bin/env python
"""Prove the Digital RF -> STI path runs, correctly, on one NVIDIA GPU.

    python chip_smoke.py               # one card: every served path
    python chip_smoke.py --four-cards  # four cards: the mesh paths only
    python chip_smoke.py --trace DIR   # also trace one STI step into DIR

Every phase goes through the entry points a user calls — ``RFDataset`` ->
``StiPipeline``, ``LiveStreamEngine``, ``SharedRefreshScheduler`` (which
merges same-shape tabs into one ``BatchedStiPipeline`` launch) and the
``pstpu`` CLI — over a capture written by the package's own Digital RF
writer at a size its users record (10 MS/s, 2 subchannels, 2^25 samples
each, ~512 MiB), and is compared with the NumPy oracle
(``ops/reference.py``) on the same samples read back on the host:

* the tone lands in its expected bin;
* max |dB difference| <= 0.05 over bins within 60 dB of each column's
  peak (a float32 cuFFT against a float64 oracle; no matmul on the path);
* the device median equals ``np.median`` of the device's own linear
  powers bit for bit.

Each phase prints one JSON line (cold seconds, warm medians of >= 5 runs
timed on the host clock around ``block_until_ready``). The last line is
``{"ok": true, "device": {...}}``; any failure exits non-zero without it.
The script refuses to run when JAX finds no GPU, and when it is not
beside the package it checks.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

#: agreement budget with the float64 oracle, and the depth below each
#: column's peak over which it is enforced
TOL_DB = 0.05
WITHIN_DB = 60.0
#: single-card vs mesh agreement budget (--four-cards)
MESH_TOL_DB = 0.01


@dataclass(frozen=True)
class Sizes:
    """Capture and request sizes; ``FULL`` is what the script runs."""

    sr: int = 10_000_000
    n_c64: int = 1 << 25            # per subchannel, 2 subchannels
    n_i16: int = 1 << 24            # 1 subchannel
    nfft: int = 4096
    nint: int = 4
    ntime: int = 128
    nfft_mid: int = 65536
    ntime_mid: int = 256
    nfft_big: int = 1 << 20
    ntime_big: int = 16
    live_initial_s: float = 0.5
    live_append_s: float = 0.1
    live_window_s: float = 0.25
    ticks: int = 4
    median_ntime: tuple = (128, 4096)
    repeats: int = 5


FULL = Sizes()
TONES_HZ = (1_250_000.0, -2_500_000.0)   # exact bins at every pow2 nfft
NOISE_RMS = 0.1


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


# ------------------------------------------------------------- comparisons
def compare_db(got_db, want_db, tol_db=TOL_DB, within_db=WITHIN_DB,
               what="") -> float:
    """Max |got - want| (dB) over bins within ``within_db`` of each
    column's peak in ``want_db``; frequency is axis 0 (the reference
    layout). Raises AssertionError beyond ``tol_db``; returns the max."""
    got_db, want_db = np.asarray(got_db), np.asarray(want_db)
    if got_db.shape != want_db.shape:
        raise AssertionError(f"{what}: shape {got_db.shape} != "
                             f"{want_db.shape}")
    if not np.isfinite(got_db).all():
        raise AssertionError(f"{what}: non-finite output")
    keep = want_db >= want_db.max(axis=0, keepdims=True) - within_db
    d = float(np.abs(got_db - want_db)[keep].max())
    if d > tol_db:
        raise AssertionError(f"{what}: max |dB diff| {d:.4g} > {tol_db}")
    return d


def check_peaks(med_db, freqs, tones_hz, what="") -> list:
    """Each subchannel's median PSD peaks in the bin nearest its tone."""
    med_db = np.asarray(med_db).reshape(len(freqs), -1)
    bins = []
    for s in range(med_db.shape[1]):
        want = int(np.argmin(np.abs(freqs - tones_hz[s])))
        got = int(np.argmax(med_db[:, s]))
        if got != want:
            raise AssertionError(f"{what}: sub {s} peak bin {got} "
                                 f"({freqs[got]:.1f} Hz), want {want}")
        bins.append(got)
    return bins


def check_median_exact(p_lin, med_lin, what="") -> None:
    """The device median equals np.median of the device's own powers."""
    want = np.median(np.asarray(p_lin), axis=0).astype(np.float32)
    if not np.array_equal(np.asarray(med_lin), want):
        raise AssertionError(f"{what}: device median != np.median")


def oracle_db(ds, entry, starts, nfft, nint, mode):
    """(nfft, ntime, nsub) oracle dBFS of the frames at absolute
    ``starts``, read on the host through RFDataset.read."""
    from pyspectrogram_tpu.ops import reference as oracle

    frame_len = nfft * nint
    cols = []
    for s in np.asarray(starts, np.int64):
        x = ds.read(int(s), frame_len, entry)
        cols.append(x.reshape(frame_len, -1))
    block = np.stack(cols, axis=1)
    return oracle.to_dbfs(oracle.sti_psd(block, nfft, nint=nint, mode=mode))


def time_calls(call, repeats):
    """(cold seconds, warm median seconds) — utils.profiling.time_calls."""
    from pyspectrogram_tpu.utils.profiling import time_calls as timed

    cold, warm = timed(call, repeats)
    return cold, float(np.median(warm))


# ------------------------------------------------------------------ phases
def write_captures(top: Path, sz: Sizes) -> dict:
    from pyspectrogram_tpu.io.synthetic import write_capture
    from pyspectrogram_tpu.native import ingest

    t0 = time.perf_counter()
    write_capture(top, channel="c64", kind="tone", n_samples=sz.n_c64,
                  sample_rate_numerator=sz.sr, num_subchannels=2,
                  freqs_hz=list(TONES_HZ), noise_rms=NOISE_RMS, seed=1)
    write_capture(top, channel="i16", kind="tone", n_samples=sz.n_i16,
                  sample_rate_numerator=sz.sr, num_subchannels=1,
                  dtype=np.dtype([("r", "<i2"), ("i", "<i2")]),
                  freqs_hz=[TONES_HZ[0]], noise_rms=NOISE_RMS, seed=2)
    dt = time.perf_counter() - t0
    try:
        import h5py
        h5 = h5py.__version__
    except ImportError:
        h5 = None
    on_disk = sum(p.stat().st_size for p in top.rglob("*.h5"))
    emit("capture", seconds=dt, bytes_on_disk=on_disk,
         native_ingest=ingest.native_available(), h5py=h5)
    return {"top": top}


def written_phases(top: Path, sz: Sizes) -> dict:
    """(a)-(f): StiPipeline(RFDataset(dir), cfg).compute() against the
    oracle; the device step alone timed on a resident block."""
    import jax.numpy as jnp

    from pyspectrogram_tpu.display.tile import make_tile_spec, tile_from_db
    from pyspectrogram_tpu.io import RFDataset
    from pyspectrogram_tpu.models import StiPipeline
    from pyspectrogram_tpu.models.sti import assemble_device_block
    from pyspectrogram_tpu.ops import stft
    from pyspectrogram_tpu.utils.config import SpectrogramConfig

    ds = RFDataset(top)
    base = SpectrogramConfig(nfft=sz.nfft, nint=sz.nint, ntime=sz.ntime,
                             mode="welch", channel="c64")
    cases = {
        "a_welch": base,
        "b_tile": replace(base, display_tile=True,
                          freq_window_khz=(-5000.0, 5000.0),
                          color_range_db=(-90.0, 0.0)),
        "c_parity": replace(base, mode="parity"),
        "d_nfft64k": replace(base, nfft=sz.nfft_mid, nint=1,
                             ntime=sz.ntime_mid),
        "e_nfft1M": replace(base, nfft=sz.nfft_big, nint=1,
                            ntime=sz.ntime_big),
        "f_int16": replace(base, channel="i16"),
    }
    results = {}
    for name, cfg in cases.items():
        pipe = StiPipeline(ds, cfg)
        t0 = time.perf_counter()
        res = pipe.compute()
        cold = time.perf_counter() - t0
        ts = []
        for _ in range(sz.repeats):
            t0 = time.perf_counter()
            res = pipe.compute()
            ts.append(time.perf_counter() - t0)
        want = oracle_db(ds, cfg.channel, res.frame_starts, cfg.nfft,
                         cfg.nint, cfg.mode)
        tones = TONES_HZ if cfg.channel == "c64" else TONES_HZ[:1]
        bins = check_peaks(res.sxx_med_dbfs, res.freqs, tones, name)
        fields = {}
        if cfg.display_tile:
            spec = make_tile_spec(res.freqs, cfg.freq_window_khz,
                                  cfg.color_range_db)
            want_tile = tile_from_db(np.moveaxis(want, 0, -1), spec)
            dl = int(np.abs(res.tile.astype(int)
                            - want_tile.astype(int)).max())
            if dl > 1:
                raise AssertionError(f"{name}: tile off by {dl} levels")
            fields["max_tile_level_diff"] = dl
        else:
            fields["max_abs_db_diff"] = compare_db(res.sxx_dbfs, want,
                                                   what=name)
        # the device program alone on a resident block, with its linear
        # powers: timing and the bit-exact median check
        chan, isub = ds._split_entry(cfg.channel)
        pm, starts_rel, _ = assemble_device_block(
            ds, chan, isub, np.asarray(res.frame_starts, np.int64),
            cfg.nfft * cfg.nint)
        fn = stft.make_sti_fn_pm(
            nfft=cfg.nfft, nint=cfg.nint, mode=cfg.mode, fft_impl="xla",
            ref=ds.ref_dict[chan], contiguous=True, return_linear=True)
        dev, st = jnp.asarray(pm), jnp.asarray(starts_rel)
        step_cold, step = time_calls(lambda: fn(dev, st), sz.repeats)
        out = fn(dev, st)
        check_median_exact(out["sxx"], out["sxx_med"], name)
        emit(f"written/{name}", nfft=cfg.nfft, nint=cfg.nint,
             ntime=cfg.ntime, mode=cfg.mode, channel=cfg.channel,
             peak_bins=bins, cold_s=cold, request_p50_s=float(np.median(ts)),
             step_cold_s=step_cold, step_p50_s=step,
             samples_per_step=int(pm.shape[1] * pm.shape[0] // 2),
             median_exact=True, **fields)
        results[name] = res
    return {"ds": ds, "results": results, "base": base}


def median_phase(sz: Sizes) -> None:
    """The time median alone: bisection above 32 rows, at the headline
    bins x subchannels, bit-exact against np.median."""
    import jax
    import jax.numpy as jnp

    from pyspectrogram_tpu.ops.stft import median_over_time

    rng = np.random.default_rng(3)
    f = jax.jit(median_over_time)
    for n in sz.median_ntime:
        p = rng.exponential(size=(n, 2, sz.nfft)).astype(np.float32)
        dev = jnp.asarray(p)
        cold, warm = time_calls(lambda: f(dev), sz.repeats)
        check_median_exact(p, f(dev), f"median/{n}")
        emit(f"median/{n}", shape=list(p.shape), cold_s=cold, p50_s=warm,
             median_exact=True)


def _append_live(w, sz: Sizes, t0: int, n: int) -> None:
    from pyspectrogram_tpu.io.synthetic import tone_signal

    x = tone_signal(n, sz.sr, TONES_HZ, start_sample=t0, noise_rms=NOISE_RMS,
                    seed=t0 % 1000)
    w.rf_write(x.astype(np.complex64))


def live_phase(root: Path, sz: Sizes) -> None:
    """LiveStreamEngine over a capture growing between ticks (appends
    through the package's writer while the engine reads), contiguous
    hops and 50% overlap-save."""
    from pyspectrogram_tpu.io import DigitalRFWriter, RFDataset
    from pyspectrogram_tpu.ops import reference as oracle
    from pyspectrogram_tpu.runtime.live import LiveStreamEngine
    from pyspectrogram_tpu.utils.config import SpectrogramConfig

    top = root / "live"
    start = 1_451_661_840 * sz.sr
    w = DigitalRFWriter(top, "live", np.complex64, start, sz.sr,
                        num_subchannels=2)
    written = int(sz.live_initial_s * sz.sr)
    _append_live(w, sz, 0, written)
    step = int(sz.live_append_s * sz.sr)
    ds = RFDataset(top)
    for hop in (sz.nfft, sz.nfft // 2):
        cfg = SpectrogramConfig(nfft=sz.nfft, nint=1, ntime=sz.ntime,
                                streaming=True, channel="live",
                                stream_seconds=sz.live_window_s, hop=hop)
        eng = LiveStreamEngine(ds, cfg)
        ticks = []
        for k in range(sz.ticks):
            if k:
                _append_live(w, sz, written, step)
                written += step
                ds.bnds_update()
            t0 = time.perf_counter()
            res = eng.tick(cfg)
            ticks.append(time.perf_counter() - t0)
        if res is None or eng.total_cols == 0:
            raise AssertionError(f"live/hop{hop}: no columns")
        # newest displayed columns against the oracle
        last = res.frame_starts[-8:]
        want = oracle_db(ds, "live", last, sz.nfft, 1, "welch")
        d_cols = compare_db(res.sxx_dbfs[:, -8:], want,
                            what=f"live/hop{hop} columns")
        # the windowed median over the ring's newest W columns
        W, total = eng.window_cols, eng.total_cols
        first = eng.start_sample + (total - W) * hop
        span = ds.read(first, (W - 1) * hop + sz.nfft, "live")
        frames = np.stack([span[j * hop:j * hop + sz.nfft]
                           for j in range(W)], axis=1)
        psd = oracle.sti_psd(frames, sz.nfft, mode="parity")
        med_want = oracle.to_dbfs(np.median(psd, axis=1))
        d_med = compare_db(res.sxx_med_dbfs, med_want,
                           what=f"live/hop{hop} median")
        bins = check_peaks(res.sxx_med_dbfs, res.freqs, TONES_HZ,
                           f"live/hop{hop}")
        emit(f"live/hop{hop}", ticks=len(ticks), cold_tick_s=ticks[0],
             tick_p50_s=float(np.median(ticks[1:])),
             window_cols=W, total_cols=total,
             samples_read=eng.samples_read, peak_bins=bins,
             max_abs_db_diff_cols=d_cols, max_abs_db_diff_median=d_med)


def big_stream_phase(ds, sz: Sizes) -> None:
    """2^20-point StreamingSti pushed twice: the first push's state is
    donated (deleted), the second push consumes only its successor."""
    import jax
    import jax.numpy as jnp

    from pyspectrogram_tpu.models.streaming import StreamingSti
    from pyspectrogram_tpu.ops.stft import to_plane_major, pack_complex_host

    nfft, k = sz.nfft_big, 2
    lo, _ = ds.bnds["c64"]
    x = ds.read(lo, 2 * k * nfft, "c64").astype(np.complex64)
    pm = to_plane_major(pack_complex_host(x))
    s = StreamingSti(nfft=nfft, nsub=2, block_len=k * nfft, ring_len=2 * k)
    st0 = s.init_state()
    times, cols = [], []
    st = st0
    for b in range(2):
        blk = jnp.asarray(pm[:, b * k * nfft:(b + 1) * k * nfft])
        t0 = time.perf_counter()
        prev = st
        st, c = s.push(st, blk)
        jax.block_until_ready(c)
        times.append(time.perf_counter() - t0)
        if not prev.ring.is_deleted():
            raise AssertionError("stream/2^20: state was not donated")
        cols.append(np.asarray(c))
    got = np.moveaxis(np.concatenate(cols), -1, 0)       # (nfft, 2k, nsub)
    want = oracle_db(ds, "c64", lo + np.arange(2 * k) * nfft, nfft, 1,
                     "welch")
    d = compare_db(got, want, what="stream/2^20")
    emit("stream/2^20", pushes=2, push_s=times, donated=True,
         max_abs_db_diff=d)


def multitab_phase(top: Path, written: dict, sz: Sizes) -> None:
    """One SharedRefreshScheduler cycle over 3 same-shape written tabs:
    one merged BatchedStiPipeline launch, each tab against the oracle."""
    from pyspectrogram_tpu.runtime import (
        ProcessorCallbacks,
        SharedRefreshScheduler,
        SpectrogramProcessor,
    )

    ds = written["ds"]
    lo, hi = ds.bnds["c64"]
    sr = float(sz.sr)
    third = (hi - lo + 1) // 3
    sched = SharedRefreshScheduler(autostart=False)
    got = {}
    tabs = []
    try:
        for i in range(3):
            span = ((lo + i * third) / sr, (lo + (i + 1) * third - 1) / sr)
            cfg = replace(written["base"], time_span=span)
            p = SpectrogramProcessor(
                "written", str(top), i, cfg,
                callbacks=ProcessorCallbacks(
                    on_iterated=lambda e: got.__setitem__(e.tab_id, e)),
                scheduler=sched)
            p.start()
            tabs.append(p)
        t0 = time.perf_counter()
        sched.tick_once()
        cold = time.perf_counter() - t0
        if sched.merged_launches != 1 or sched.merged_requests != 3:
            raise AssertionError(
                f"multitab: {sched.merged_launches} merged launches for "
                f"{sched.merged_requests} requests, want 1 for 3")
        ts = []
        for _ in range(sz.repeats):
            for p in tabs:
                p._last_key = None                  # dirty every cycle
            t0 = time.perf_counter()
            sched.tick_once()
            ts.append(time.perf_counter() - t0)
        diffs = []
        for i in range(3):
            e = got[i]
            starts = tabs[i].pipeline.ds.sti_frame_starts(
                *tabs[i].pipeline._resolve_span(
                    tabs[i].config, "c64", ds.sr_dict["c64"]),
                sz.nfft, sz.nint, sz.ntime)
            want = oracle_db(ds, "c64", starts, sz.nfft, sz.nint, "welch")
            diffs.append(compare_db(e.sxx_dbfs, want, what=f"tab{i}"))
            check_peaks(e.sxx_med_dbfs, e.freqs, TONES_HZ, f"tab{i}")
    finally:
        for p in tabs:
            p.abort()
    emit("multitab/3", merged_launches=1, cold_cycle_s=cold,
         cycle_p50_s=float(np.median(ts)), max_abs_db_diff=max(diffs))


def cli_phase(top: Path, written: dict, sz: Sizes) -> None:
    """`pstpu psd` in this process (a second JAX process could not get
    the card's memory)."""
    import contextlib
    import io

    from pyspectrogram_tpu.clients.cli import main as cli_main

    out = top.parent / "psd.csv"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["psd", str(top), "--out", str(out), "--channel",
                       "c64", "--subchannel", "1", "--nfft", str(sz.nfft),
                       "--nint", str(sz.nint), "--ntime", str(sz.ntime)])
    dt = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli psd exited {rc}")
    csv = np.loadtxt(out, delimiter=",", skiprows=1)
    ref = written["results"]["a_welch"]
    np.testing.assert_array_equal(csv[:, 0], ref.freqs)
    d = compare_db(csv[:, 1:2], ref.sxx_med_dbfs[:, 1:2], tol_db=1e-3,
                   what="cli psd vs pipeline")
    check_peaks(csv[:, 1], ref.freqs, TONES_HZ[1:], "cli psd")
    emit("cli/psd", seconds=dt, rows=int(csv.shape[0]),
         max_abs_db_diff_vs_pipeline=d)


def trace_phase(written: dict, sz: Sizes, trace_dir: Path) -> None:
    """One profiler trace of the plain STI step at shape (a), reduced to
    device time per kernel name."""
    import gzip

    import jax
    import jax.numpy as jnp

    from pyspectrogram_tpu.models.sti import assemble_device_block
    from pyspectrogram_tpu.ops import stft

    ds, res = written["ds"], written["results"]["a_welch"]
    pm, starts_rel, _ = assemble_device_block(
        ds, "c64", None, np.asarray(res.frame_starts, np.int64),
        sz.nfft * sz.nint)
    fn = stft.make_sti_fn_pm(nfft=sz.nfft, nint=sz.nint, contiguous=True)
    dev, st = jnp.asarray(pm), jnp.asarray(starts_rel)
    jax.block_until_ready(fn(dev, st))
    steps = 10
    jax.profiler.start_trace(str(trace_dir), create_perfetto_trace=True)
    for _ in range(steps):
        out = fn(dev, st)
    jax.block_until_ready(out)
    jax.profiler.stop_trace()
    traces = sorted(trace_dir.rglob("perfetto_trace.json.gz"))
    if not traces:
        raise AssertionError("trace: no perfetto trace written")
    with gzip.open(traces[-1], "rt") as fh:
        data = json.load(fh)
    events = data["traceEvents"] if isinstance(data, dict) else data
    names = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    dev_pids = {p for p, n in names.items() if "gpu" in n.lower()
                and "/device:" in n.lower()}
    per_kernel: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("pid") in dev_pids:
            k = per_kernel.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += float(e.get("dur", 0.0))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
    emit("trace/a_welch", steps=steps, trace=str(traces[-1]),
         processes=sorted(names.values()),
         device_processes=sorted(names[p] for p in dev_pids),
         kernels=[{"name": n[:120], "calls": c, "us_per_step": us / steps}
                  for n, (c, us) in top[:25]])


# -------------------------------------------------------------- four cards
def four_card_phases(top: Path, sz: Sizes) -> None:
    """The mesh paths on 4 cards, each against the single-card result on
    the same data: column-sharded and contiguous-tile StiPipeline, the
    mesh-DP batched program, the chan-sharded stream (incl. overlap-save)
    and the dist-FFT tier at 2^20."""
    import jax
    import jax.numpy as jnp

    from pyspectrogram_tpu.io import RFDataset
    from pyspectrogram_tpu.models import BatchedStiPipeline, StiPipeline
    from pyspectrogram_tpu.models.streaming import StreamingSti
    from pyspectrogram_tpu.ops.stft import (
        median_over_time_psum,
        pack_complex_host,
        to_plane_major,
    )
    from pyspectrogram_tpu.parallel import make_mesh
    from pyspectrogram_tpu.parallel.mesh import TIME_AXIS
    from pyspectrogram_tpu.utils.config import SpectrogramConfig

    devs = jax.devices()[:4]
    ds = RFDataset(top)
    base = SpectrogramConfig(nfft=sz.nfft, nint=sz.nint, ntime=sz.ntime,
                             channel="c64")

    def spread(arr, what):
        used = {s.device for s in arr.addressable_shards}
        if len(used) < 2:
            raise AssertionError(f"{what}: every shard on {used}")
        return len(used)

    # column-sharded written refresh, two mesh shapes
    single = StiPipeline(ds, base).compute()
    for tp, cp in ((4, 1), (2, 2)):
        mesh = make_mesh(devs, time_parallel=tp, chan_parallel=cp)
        pipe = StiPipeline(ds, base, mesh=mesh)
        t0 = time.perf_counter()
        res = pipe.compute()
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = pipe.compute()
        warm = time.perf_counter() - t0
        d = compare_db(res.sxx_dbfs, single.sxx_dbfs, MESH_TOL_DB,
                       what=f"mesh{tp}x{cp}")
        dm = compare_db(res.sxx_med_dbfs, single.sxx_med_dbfs, MESH_TOL_DB,
                        what=f"mesh{tp}x{cp} median")
        emit(f"mesh/sti/{tp}x{cp}", cold_s=cold, request_s=warm,
             max_abs_db_diff=d, max_abs_db_diff_median=dm)

    # contiguous tile on the mesh
    tcfg = replace(base, display_tile=True, freq_window_khz=(-5000.0,
                                                             5000.0),
                   color_range_db=(-90.0, 0.0))
    t_single = StiPipeline(ds, tcfg).compute()
    t_mesh = StiPipeline(ds, tcfg, mesh=make_mesh(devs)).compute()
    dl = int(np.abs(t_mesh.tile.astype(int)
                    - t_single.tile.astype(int)).max())
    if dl > 1:
        raise AssertionError(f"mesh tile off by {dl} levels")
    emit("mesh/tile/4x1", max_tile_level_diff=dl)

    # exact median over a time-sharded cube (psum'd bisection)
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(devs)
    p = np.random.default_rng(3).exponential(
        size=(sz.ntime, 2, sz.nfft)).astype(np.float32)
    f = jax.jit(shard_map(
        lambda x: median_over_time_psum(x, TIME_AXIS, sz.ntime), mesh=mesh,
        in_specs=P(TIME_AXIS), out_specs=P(), check_vma=False))
    pdev = jax.device_put(jnp.asarray(p), NamedSharding(mesh, P(TIME_AXIS)))
    spread(pdev, "median cube")
    check_median_exact(p, f(pdev), "mesh median")
    emit("mesh/median_psum", median_exact=True)

    # mesh-DP batched program: 3 requests in one launch
    lo, hi = ds.bnds["c64"]
    third = (hi - lo + 1) // 3
    spans = [((lo + i * third) / sz.sr, (lo + (i + 1) * third - 1) / sz.sr)
             for i in range(3)]
    reqs = [(ds, "c64")] * 3
    b_single = BatchedStiPipeline(reqs, base).compute(time_spans=spans)
    b_mesh = BatchedStiPipeline(reqs, base, mesh=mesh).compute(
        time_spans=spans)
    d = max(compare_db(m.sxx_dbfs, s.sxx_dbfs, MESH_TOL_DB,
                       what=f"batched req{i}")
            for i, (m, s) in enumerate(zip(b_mesh, b_single)))
    emit("mesh/batched/3", max_abs_db_diff=d)

    # chan-sharded stream, contiguous and overlap-save hops
    x = ds.read(lo, 64 * sz.nfft, "c64").astype(np.complex64)
    pm = to_plane_major(pack_complex_host(x))
    smesh = make_mesh(devs, time_parallel=2, chan_parallel=2)
    for hop in (sz.nfft, sz.nfft // 2):
        k = 8
        kw = dict(nfft=sz.nfft, nsub=2, block_len=k * hop, hop=hop,
                  ring_len=32)
        one, four = StreamingSti(**kw), StreamingSti(**kw, mesh=smesh)
        s1, s4 = one.init_state(), four.init_state()
        for b in range(4):
            blk = pm[:, b * k * hop:(b + 1) * k * hop]
            s1, c1 = one.push(s1, jnp.asarray(blk))
            s4, c4 = four.push(s4, jax.device_put(jnp.asarray(blk),
                                                  four.block_sharding()))
        ndev = spread(s4.ring, f"stream hop{hop} ring")
        d = compare_db(np.moveaxis(np.asarray(c4), -1, 0),
                       np.moveaxis(np.asarray(c1), -1, 0), MESH_TOL_DB,
                       what=f"stream hop{hop}")
        dm = compare_db(four.median_psd(s4).T, one.median_psd(s1).T,
                        MESH_TOL_DB, what=f"stream hop{hop} median")
        emit(f"mesh/stream/hop{hop}", ring_devices=ndev, max_abs_db_diff=d,
             max_abs_db_diff_median=dm)

    # dist-FFT tier at 2^20: one plane pair over a 2-wide chan axis
    bcfg = replace(base, channel="c64:0", nfft=sz.nfft_big, nint=1,
                   ntime=sz.ntime_big)
    bmesh = make_mesh(devs, time_parallel=2, chan_parallel=2)
    bpipe = StiPipeline(ds, bcfg, mesh=bmesh)
    if not bpipe._use_bigfft(bcfg, 1):
        raise AssertionError("2^20 request did not take the dist-FFT tier")
    t0 = time.perf_counter()
    res = bpipe.compute()
    cold = time.perf_counter() - t0
    b1 = StiPipeline(ds, bcfg).compute()
    d = compare_db(res.sxx_dbfs, b1.sxx_dbfs, MESH_TOL_DB, what="bigfft")
    check_peaks(res.sxx_med_dbfs, res.freqs, TONES_HZ[:1], "bigfft")
    emit("mesh/bigfft/2^20", cold_s=cold, max_abs_db_diff=d)


# -------------------------------------------------------------------- main
def import_package():
    """The package beside this script, never another copy."""
    sys.path.insert(0, str(REPO))
    try:
        import pyspectrogram_tpu
    except ImportError:
        fail(f"the package is not beside {Path(__file__).name} ({REPO})")
    if Path(pyspectrogram_tpu.__file__).resolve().parent.parent != REPO:
        fail(f"imported {pyspectrogram_tpu.__file__}, not the checkout "
             f"at {REPO}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh paths, on 4 GPUs")
    ap.add_argument("--trace", type=Path, default=None, metavar="DIR",
                    help="also trace the plain STI step of shape (a)")
    args = ap.parse_args(argv)
    import_package()
    from pyspectrogram_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    devices = jax.devices()
    if jax.default_backend() != "gpu" or devices[0].platform != "gpu":
        fail(f"no GPU: JAX's backend is {jax.default_backend()!r}")
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        fail(f"--four-cards needs 4 GPUs; {len(devices)} visible")
    from pyspectrogram_tpu.utils.profiling import card_line

    print(f"card: {card_line()}", flush=True)
    sz = FULL
    with tempfile.TemporaryDirectory(prefix="pstpu_smoke_") as tmp:
        top = Path(tmp) / "capture"
        write_captures(top, sz)
        if args.four_cards:
            four_card_phases(top, sz)
        else:
            written = written_phases(top, sz)
            median_phase(sz)
            live_phase(Path(tmp), sz)
            big_stream_phase(written["ds"], sz)
            multitab_phase(top, written, sz)
            cli_phase(top, written, sz)
            if args.trace is not None:
                args.trace.mkdir(parents=True, exist_ok=True)
                trace_phase(written, sz, args.trace)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
