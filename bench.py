#!/usr/bin/env python
"""Benchmark: STI throughput and latency on one GPU.

Prints ONE JSON line for the default shape:
  {"metric": ..., "value": N, "unit": "samples/s", "p50_ms": ...,
   "device": {"platform", "kind", "count"}}
Times are host-clock readings around ``jax.block_until_ready``, one step
per reading, after a warm-up call that compiles. The card's name and power
limit go to stderr beside the device JAX reports. The script refuses to run
unless JAX's default backend is the GPU: a CPU number is not a device
number.

Run `python bench.py --all` for the full suite (multiple nfft and modes,
streaming pushes, display readback, the merged multi-tab cycle) printed as
extra lines to stderr.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from pyspectrogram_tpu.utils.profiling import card_line, time_calls


def _make_inputs(nfft, nint, ntime, nsub, seed=0):
    """Plane-major complex input: (nsub*2, nsamp) float32 — the canonical
    device-boundary layout — with frames packed at t*frame_len."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    nsamp = nfft * nint * ntime
    x = rng.standard_normal((nsub * 2, nsamp)).astype(np.float32)
    starts = (np.arange(ntime) * nfft * nint).astype(np.int32)
    return jnp.asarray(x), jnp.asarray(starts)


def bench_sti(nfft=4096, nint=4, ntime=128, nsub=2, mode="welch",
              iters=50, precision="exact"):
    """Returns (samples_per_sec at the p50 step, p50_step_s, p99_step_s)
    of the production single-device STI program."""
    from pyspectrogram_tpu.ops.stft import make_sti_fn_pm

    fn = make_sti_fn_pm(nfft=nfft, nint=nint, mode=mode, contiguous=True,
                        precision=precision)
    samples, starts = _make_inputs(nfft, nint, ntime, nsub)
    n_proc = nfft * nint * ntime * nsub  # samples consumed per step
    _, ts = time_calls(lambda: fn(samples, starts), iters)
    p50 = float(np.percentile(ts, 50))
    return n_proc / p50, p50, float(np.percentile(ts, 99))


def bench_streaming(nfft=4096, nint=1, nsub=2, cols_per_block=8,
                    ring_len=256, iters=200, precision="exact", hop=None):
    """(samples_per_sec, p50 push seconds) of the streaming ring path: one
    donated push per reading (the production ingest variant, no dB
    columns). ``hop`` < nfft*nint measures overlap-save."""
    import jax.numpy as jnp

    from pyspectrogram_tpu.models.streaming import StreamingSti

    block_len = (nfft * nint if hop is None else hop) * cols_per_block
    s = StreamingSti(nfft=nfft, nint=nint, nsub=nsub, block_len=block_len,
                     ring_len=ring_len, precision=precision, hop=hop)
    rng = np.random.default_rng(0)
    block = jnp.asarray(
        rng.standard_normal((nsub * 2, block_len)).astype(np.float32))
    box = [s.init_state()]

    def push():
        # the state is donated: thread it through, never reuse the old one
        box[0], _ = s.push(box[0], block, return_db=False)
        return box[0].ring

    _, ts = time_calls(push, iters)
    p50 = float(np.percentile(ts, 50))
    return block_len * nsub / p50, p50


def bench_multitab(B=7, nfft=1024, ntime=100, iters=15, cache_root=None):
    """End-to-end merged multi-tab refresh (runtime.scheduler): B
    GUI-shaped display-tile tabs over one capture, one merged
    BatchedStiPipeline launch per cycle vs B per-tab dispatches (the
    reference's 7-thread pattern, drfview.py:178). An INFO row (not
    GS/s-gated): host IO and transfer share the cycle.

    Returns {"merged_ms", "solo_ms", "speedup"} per refresh cycle."""
    import json as _json

    from pyspectrogram_tpu.io.reader import RFDataset
    from pyspectrogram_tpu.io.synthetic import write_capture
    from pyspectrogram_tpu.models import StiPipeline
    from pyspectrogram_tpu.runtime import (
        ProcessorCallbacks,
        SharedRefreshScheduler,
        SpectrogramProcessor,
    )
    from pyspectrogram_tpu.utils.config import SpectrogramConfig

    # ~10 window-spans of data, capped at the pinned row's 2^20; small
    # smoke shapes get a proportionally small capture. Marker-cached like
    # bench_e2e so repeated runs reuse the written capture.
    n_samples = min(1 << 20, max(nfft * ntime * 10, 1 << 13))
    root = (Path(cache_root) if cache_root is not None
            else Path(tempfile.gettempdir()) / "pstpu_mtab")
    top = root / f"n{n_samples}"
    marker = top / "complete.json"
    if not marker.exists():
        import shutil

        shutil.rmtree(top, ignore_errors=True)
        top.mkdir(parents=True, exist_ok=True)
        write_capture(top, channel="ant0", kind="tone",
                      n_samples=n_samples,
                      sample_rate_numerator=1_000_000,
                      freqs_hz=[125_000.0])
        marker.write_text(_json.dumps({"n_samples": n_samples}))
    cfg = SpectrogramConfig(nfft=nfft, nint=1, ntime=ntime,
                            display_tile=True)
    sched = SharedRefreshScheduler(autostart=False)
    tabs = []
    try:
        for i in range(B):
            p = SpectrogramProcessor(
                "written", str(top), i,
                cfg.replace(color_range_db=(-110.0 - i, -40.0)),
                callbacks=ProcessorCallbacks(on_iterated=lambda e: None),
                scheduler=sched)
            p.start()
            tabs.append(p)
        sched.tick_once()                       # compile the merged path
        solos = [StiPipeline(p.ds, p.config) for p in tabs]
        for s in solos:
            s.compute()                         # compile the solo path
        t0 = time.perf_counter()
        for _ in range(iters):
            for p in tabs:
                p._last_key = None              # dirty every cycle
            sched.tick_once()
        merged_ms = (time.perf_counter() - t0) / iters * 1e3
        t0 = time.perf_counter()
        for _ in range(iters):
            for s in solos:
                # refresh_bounds=True: the merged cycle pays a per-tab
                # bnds_update (scheduler._tick), and so would N per-tab
                # threads — a bare compute would understate the baseline
                s.compute()
        solo_ms = (time.perf_counter() - t0) / iters * 1e3
    finally:
        for p in tabs:
            p.abort()
    return {"merged_ms": round(merged_ms, 1), "solo_ms": round(solo_ms, 1),
            "speedup": round(solo_ms / merged_ms, 2)}


def bench_display(nfft=4096, nsub=2, ring_len=256,
                  frange_khz=(-250.0, 250.0), repeats=7):
    """Readback cost of one display refresh: full float snapshot (what a
    client without the on-device display path must transfer) vs the
    on-device uint8 tile (crop + decimate + quantize fused on device, only
    level indices leave device memory — the north-star display path,
    BASELINE.md).

    Returns {"float_bytes", "tile_bytes", "float_ms", "tile_ms",
    "byte_reduction", "speedup"} per refresh of a ring_len-column ring.
    """
    import jax.numpy as jnp
    from pyspectrogram_tpu.display import make_tile_spec
    from pyspectrogram_tpu.models.streaming import StreamingSti
    from pyspectrogram_tpu.ops.stft import shifted_freqs

    s = StreamingSti(nfft=nfft, nsub=nsub, block_len=nfft * 8,
                     ring_len=ring_len)
    rng = np.random.default_rng(0)
    state = s.init_state()
    block = jnp.asarray(
        rng.standard_normal((nsub * 2, nfft * 8)).astype(np.float32))
    for _ in range(ring_len // 8):  # fill the ring once
        state, _ = s.push(state, block, return_db=False)
    spec = make_tile_spec(shifted_freqs(nfft, 1_000_000), frange_khz,
                          (-110.0, -40.0))
    db, _ = s.snapshot(state)
    tile, _ = s.snapshot_quantized(state, spec)
    # snapshot* read back to host numpy, so each call is synchronous
    t_float = float(np.median(time_calls(lambda: s.snapshot(state),
                                         repeats)[1]))
    t_tile = float(np.median(time_calls(
        lambda: s.snapshot_quantized(state, spec), repeats)[1]))
    return {
        "float_bytes": int(db.nbytes),
        "tile_bytes": int(tile.nbytes),
        "byte_reduction": round(db.nbytes / tile.nbytes, 2),
        "float_ms": round(t_float * 1e3, 3),
        "tile_ms": round(t_tile * 1e3, 3),
        "speedup": round(t_float / t_tile, 2),
    }


def bench_e2e(gb=0.5, nfft=4096, nint=2, ntime=256, nsub=2,
              cache_root=None, depth=2, dtype="c64"):
    """Sustained DISK -> assemble -> device -> STI throughput.

    This measures the path the reference was actually slow at — its
    per-column HDF5 read loop (reference: drfProc.py:161-166) — end to
    end: pooled GIL-free HDF5 reads (io.fastread), native C++ frame
    assembly, double-buffered device_put (io.ingest.PrefetchFeeder
    overlapping host IO with device compute), the STI program, per-window
    median readback.

    Returns (e2e_samples_per_sec, host_samples_per_sec, meta): host_… is
    the same loop minus the device (disk -> plane-major frames), i.e. the
    pure ingest rate.
    """
    import json as _json

    import jax.numpy as jnp

    from pyspectrogram_tpu.io.ingest import PrefetchFeeder
    from pyspectrogram_tpu.io.reader import RFDataset
    from pyspectrogram_tpu.io.synthetic import write_capture
    from pyspectrogram_tpu.models.sti import assemble_device_block
    from pyspectrogram_tpu.ops.stft import make_sti_fn_pm

    if dtype == "i16":
        # raw integer captures ship at half the bytes (4 B/sample);
        # the dBFS ref folds into the power scale
        sample_dtype = np.dtype([("r", np.int16), ("i", np.int16)])
        bytes_per, ref = 4, 2.0 ** 15.5
    else:
        sample_dtype, bytes_per, ref = np.complex64, 8, 1.0
    n_samples = max(int(gb * 2**30) // (bytes_per * nsub),
                    nfft * nint * ntime)
    key = f"{dtype}_n{n_samples}_sub{nsub}"
    root = (Path(cache_root) if cache_root is not None
            else Path(tempfile.gettempdir()) / "pstpu_e2e")
    top = root / key
    marker = top / "complete.json"
    if not marker.exists():
        import shutil

        shutil.rmtree(top, ignore_errors=True)
        top.mkdir(parents=True, exist_ok=True)
        write_capture(top, channel="e2e", kind="noise",
                      n_samples=n_samples, sample_rate_numerator=4_000_000,
                      num_subchannels=nsub, dtype=sample_dtype)
        marker.write_text(_json.dumps({"n_samples": n_samples}))

    ds = RFDataset(top)
    lo, hi = ds.bnds["e2e"]
    frame_len = nfft * nint
    win_samples = frame_len * ntime
    n_windows = (hi - lo + 1) // win_samples
    starts = [lo + k * win_samples for k in range(n_windows)]
    fn = make_sti_fn_pm(nfft=nfft, nint=nint, mode="welch", contiguous=True,
                        ref=ref)
    starts_rel = jnp.asarray(
        (np.arange(ntime) * frame_len).astype(np.int32))

    def produce(k):
        n_st = starts[k] + np.arange(ntime, dtype=np.int64) * frame_len
        pm, _, _ = assemble_device_block(ds, "e2e", None, n_st, frame_len)
        return jnp.asarray(pm)

    # warm: compile + page-cache the capture once
    float(np.asarray(fn(produce(0), starts_rel)["sxx_med_dbfs"]).sum())

    t0 = time.perf_counter()
    feeder = PrefetchFeeder(produce, n_windows, depth=depth)
    acc = 0.0
    for pm in feeder:
        out = fn(pm, starts_rel)
        acc += float(np.asarray(out["sxx_med_dbfs"][0, 0]))
    e2e_dt = time.perf_counter() - t0

    # host-only: identical loop minus device transfer/compute
    t0 = time.perf_counter()
    for k in range(n_windows):
        n_st = starts[k] + np.arange(ntime, dtype=np.int64) * frame_len
        assemble_device_block(ds, "e2e", None, n_st, frame_len)
    host_dt = time.perf_counter() - t0

    total = n_windows * win_samples * nsub
    meta = {"windows": n_windows, "gb": total * bytes_per / 2**30,
            "acc": acc}
    return total / e2e_dt, total / host_dt, meta


def measure_row(key, args):
    """Run the single measurement behind an --all row ``key``; returns
    ``(gs, p50_ms, extra)``."""
    parts = key.split("/")
    if parts[0] == "sti":
        nfft, mode = int(parts[1]), parts[2]
        sps, p50, p99 = bench_sti(
            nfft=nfft, nint=args.nint, ntime=args.ntime, nsub=args.nsub,
            mode=mode, iters=args.iters)
        return sps / 1e9, p50 * 1e3, {"p99_ms": p99 * 1e3}
    if parts[0] == "stream":
        nfft, tier = int(parts[1]), parts[2]
        kw = {}
        if tier.startswith("overlap"):
            kw["hop"] = int(tier[len("overlap"):])
        sps, p50 = bench_streaming(nfft=nfft, iters=args.iters, **kw)
        return sps / 1e9, p50 * 1e3, {}
    raise ValueError(f"unknown row key {key!r}")


def run_all(args):
    """The --all suite: run every standard row, narrate to stderr, and
    return machine-readable [{key, gs, p50_ms}, ...] for the snapshot /
    regression check (each row's key is stable across runs)."""
    rows = []
    keys = ([f"sti/{nfft}/{mode}" for nfft in (1024, 4096, 65536)
             for mode in ("welch", "parity")]
            + ["stream/4096/exact", "stream/4096/overlap2048"])
    for key in keys:
        try:
            gs, p50_ms, extra = measure_row(key, args)
        except Exception as e:
            print(f"# {key} FAILED: {e}", file=sys.stderr)
            continue
        print(f"# {key:24s} {gs:8.3f} GS/s  p50={p50_ms:7.3f} ms"
              + (f"  p99={extra['p99_ms']:7.3f} ms" if extra else ""),
              file=sys.stderr)
        rows.append({"key": key, "gs": round(gs, 3),
                     "p50_ms": round(p50_ms, 4)})
    try:
        d = bench_display(nfft=4096)
        print(f"# display refresh   float {d['float_bytes']/2**20:.2f} "
              f"MiB/{d['float_ms']:.1f} ms -> tile "
              f"{d['tile_bytes']/2**20:.2f} MiB/{d['tile_ms']:.1f} ms "
              f"({d['byte_reduction']}x bytes, {d['speedup']}x time)",
              file=sys.stderr)
        rows.append({"key": "display/4096/refresh",
                     "tile_ms": round(d["tile_ms"], 2),
                     "speedup": d["speedup"]})
    except Exception as e:
        print(f"# display FAILED: {e}", file=sys.stderr)
    try:
        m = bench_multitab()
        print(f"# multi-tab (B=7)   merged {m['merged_ms']:.1f} ms/cycle "
              f"vs {m['solo_ms']:.1f} as 7 dispatches "
              f"({m['speedup']}x)", file=sys.stderr)
        rows.append({"key": "mtab/7/display", **m})
    except Exception as e:
        print(f"# multitab FAILED: {e}", file=sys.stderr)
    return rows


def check_snapshot(rows, path, tolerance):
    """Diff a fresh --all run against a pinned snapshot: every GS/s row
    must stay within ``tolerance`` (fraction) of its pinned value and no
    row may disappear; rows without a rate are reported, not gated."""
    with open(path) as f:
        pinned = json.load(f)
    got = {r["key"]: r for r in rows}
    ok = True
    for want in pinned["rows"]:
        key, have = want["key"], got.get(want["key"])
        if have is None:
            print(f"# CHECK MISSING {key} (was in snapshot)", file=sys.stderr)
            ok = False
        elif "gs" in want:
            lo = want["gs"] * (1 - tolerance)
            status = "ok" if have["gs"] >= lo else "REGRESSED"
            ok &= status == "ok"
            print(f"# CHECK {status:9s} {key}: {have['gs']:.3f} GS/s "
                  f"(pinned {want['gs']:.3f}, floor {lo:.3f})",
                  file=sys.stderr)
    print(f"# CHECK {'PASS' if ok else 'FAIL'} vs {path} "
          f"(tolerance {tolerance:.0%})", file=sys.stderr)
    return ok


def device_info():
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true", help="full suite to stderr")
    ap.add_argument("--nfft", type=int, default=4096)
    ap.add_argument("--nint", type=int, default=4)
    ap.add_argument("--ntime", type=int, default=128)
    ap.add_argument("--nsub", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50,
                    help="timed calls per row (each blocks until ready)")
    ap.add_argument("--precision", default="exact",
                    choices=["exact", "balanced", "display"])
    ap.add_argument("--display", action="store_true",
                    help="measure display-refresh readback: float vs tile")
    ap.add_argument("--e2e", action="store_true",
                    help="measure sustained disk->device->STI instead")
    ap.add_argument("--e2e-gb", type=float, default=0.5,
                    help="synthetic capture size for --e2e (GiB)")
    ap.add_argument("--e2e-dtype", default="c64", choices=["c64", "i16"],
                    help="capture dtype for --e2e (i16 halves the bytes)")
    ap.add_argument("--snapshot", default=None, metavar="PATH",
                    help="run the --all suite and pin it as JSON")
    ap.add_argument("--check", default=None, metavar="PATH",
                    help="run the --all suite and FAIL (exit 1) if any "
                         "GS/s row fell below the pinned snapshot by "
                         "more than --tolerance")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a jax.profiler device trace of the "
                         "headline measurement into DIR (TensorBoard "
                         "format; utils.profiling.device_trace)")
    ap.add_argument("--tolerance", type=float, default=0.10,
                    help="allowed fractional drop for --check (default 10%%)")
    args = ap.parse_args()

    from pyspectrogram_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX's backend is "
                 f"{jax.default_backend()!r}")
    device = device_info()
    print(f"# device: {device}  card: {card_line()}", file=sys.stderr)

    if args.display:
        d = bench_display(nfft=args.nfft, nsub=args.nsub)
        print(json.dumps({
            "metric": f"display_refresh_readback_nfft{args.nfft}",
            "value": d["tile_ms"],
            "unit": "ms",
            **d,
            "device": device,
        }))
        return

    if args.e2e:
        e2e_sps, host_sps, meta = bench_e2e(
            gb=args.e2e_gb, nfft=args.nfft, nint=args.nint, nsub=args.nsub,
            dtype=args.e2e_dtype)
        print(json.dumps({
            "metric": f"sti_e2e_disk_to_device_nfft{args.nfft}_{args.e2e_dtype}",
            "value": round(e2e_sps, 1),
            "unit": "samples/s",
            "host_ingest_samples_per_s": round(host_sps, 1),
            "windows": meta["windows"],
            "gb": round(meta["gb"], 3),
            "device": device,
        }))
        return

    if args.all or args.check or args.snapshot:
        rows = run_all(args)
        if args.snapshot:
            with open(args.snapshot, "w") as f:
                json.dump({"rows": rows, "device": device, "config": {
                    "nint": args.nint, "ntime": args.ntime,
                    "nsub": args.nsub}}, f, indent=1)
            print(f"# snapshot -> {args.snapshot} ({len(rows)} rows)",
                  file=sys.stderr)
        if args.check and not check_snapshot(rows, args.check,
                                             args.tolerance):
            sys.exit(1)

    def headline():
        return bench_sti(nfft=args.nfft, nint=args.nint, ntime=args.ntime,
                         nsub=args.nsub, iters=args.iters,
                         precision=args.precision)

    if args.trace:
        from pyspectrogram_tpu.utils.profiling import device_trace

        with device_trace(args.trace):
            sps, p50, p99 = headline()
    else:
        sps, p50, p99 = headline()
    result = {
        "metric": f"sti_throughput_c64_nfft{args.nfft}",
        "value": round(sps, 1),
        "unit": "samples/s",
        "p50_ms": round(p50 * 1e3, 4),
        "p99_ms": round(p99 * 1e3, 4),
    }
    try:
        _, sp50 = bench_streaming(nfft=args.nfft, iters=args.iters)
        result["stream_p50_ms"] = round(sp50 * 1e3, 4)
    except Exception as e:  # latency extra must never sink the headline
        print(f"# streaming p50 FAILED: {e}", file=sys.stderr)
    result["device"] = device
    print(json.dumps(result))


if __name__ == "__main__":
    main()
