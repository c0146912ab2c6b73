"""The incremental live path (runtime.live): O(delta) reads per refresh,
ring columns identical to a from-scratch recompute, display decimation on
device, settings-change re-init, and producer-outran-consumer recovery.

This is the behavior the reference's streaming mode lacks — it re-reads
and recomputes the whole trailing window every 0.08 s tick (reference:
drfProc.py:239-241, 291-293)."""

import numpy as np
import pytest

from pyspectrogram_tpu.io.reader import RFDataset
from pyspectrogram_tpu.io.synthetic import tone_signal
from pyspectrogram_tpu.io.writer import DigitalRFWriter
from pyspectrogram_tpu.runtime.live import LiveStreamEngine, _EngineSlot
from pyspectrogram_tpu.utils.config import SpectrogramConfig


SR = 100_000
START = 1_451_661_840 * SR


def _growing_writer(tmp_path, n0):
    w = DigitalRFWriter(
        tmp_path, "live", np.complex64, start_global_index=START,
        sample_rate_numerator=SR, file_cadence_millisecs=100,
        subdir_cadence_secs=1,
    )
    w.rf_write(tone_signal(n0, SR, [12_500.0]).astype(np.complex64))
    return w


def _count_reads(ds):
    """Wrap read_vector_raw to record each read's sample span."""
    spans = []
    orig = ds.reader.read_vector_raw

    def counting(start, n, chan, **kw):
        spans.append(int(n))
        return orig(start, n, chan, **kw)

    ds.reader.read_vector_raw = counting
    return spans


def test_tick_reads_are_o_delta_not_o_window(tmp_path):
    """THE round-4 pin: after the initial window fill, each tick reads only
    the samples appended since the previous tick — never the window."""
    n0 = 60_000
    w = _growing_writer(tmp_path, n0)
    ds = RFDataset(tmp_path)
    cfg = SpectrogramConfig(nfft=64, ntime=16, stream_seconds=0.5,
                            streaming=True)
    # small blocks so granularity is far below the window
    eng = LiveStreamEngine(ds, cfg, target_block_samples=4096)
    spans = _count_reads(ds)
    window_samples = eng.window_cols * eng.hop
    assert window_samples == 50_048  # ceil(0.5s * 100k / 64) * 64

    eng.tick(cfg)
    initial = sum(spans)
    # cold start: at most one window (+ one block of rounding)
    assert initial <= window_samples + eng.block_len

    for it in range(3):
        delta = 7_000
        w.rf_write(tone_signal(delta, SR, [12_500.0],
                               start_sample=n0).astype(np.complex64))
        n0 += delta
        ds.bnds_update()
        before = sum(spans)
        eng.tick(cfg)
        read = sum(spans) - before
        # reads the delta (whole blocks), NOT the window
        assert read <= delta + eng.block_len
        assert read < window_samples / 4


def test_ring_columns_equal_recompute(tone_capture):
    """Every displayed live column is bit-comparable to a from-scratch
    STI over the same frames (the fused batch path, ops.stft)."""
    import jax.numpy as jnp

    from pyspectrogram_tpu.models.sti import assemble_device_block
    from pyspectrogram_tpu.ops import stft

    top, meta = tone_capture
    ds = RFDataset(top)
    # sr 1e6, nfft 256, nint 2: window 0.01 s -> ceil(10000/512)=20 cols;
    # ntime >= W so the display stride is 1 (every column shown)
    cfg = SpectrogramConfig(nfft=256, nint=2, ntime=64, stream_seconds=0.01,
                            streaming=True)
    eng = LiveStreamEngine(ds, cfg)
    res = eng.tick(cfg)
    assert res is not None
    W = eng.window_cols
    assert res.sxx_dbfs.shape == (256, W, 2)

    chan = meta["channel"]
    fn = stft.make_sti_fn_pm(
        nfft=256, nint=2, mode=cfg.mode, window=cfg.window,
        ref=ds.ref_dict[chan], contiguous=True)
    pm, starts_rel, _ = assemble_device_block(
        ds, chan, None, res.frame_starts, 512)
    out = fn(jnp.asarray(pm), jnp.asarray(starts_rel))
    want = stft.to_reference_layout(np.asarray(out["sxx_dbfs"])[:W])
    np.testing.assert_allclose(res.sxx_dbfs, want, atol=1e-4)
    want_med = np.moveaxis(np.asarray(out["sxx_med_dbfs"]), -1, 0)
    np.testing.assert_allclose(res.sxx_med_dbfs, want_med, atol=1e-4)
    # times/frame_starts agree: hop-spaced, ending at the capture tail
    assert np.all(np.diff(res.frame_starts) == 512)
    lo, hi = ds.bnds[chan]
    assert res.frame_starts[-1] + 512 == hi + 1


def test_display_stride_decimation(tone_capture):
    """ntime < window columns: the device snapshot strides so at most
    ntime rows are read back, evenly covering the window."""
    top, meta = tone_capture
    ds = RFDataset(top)
    cfg = SpectrogramConfig(nfft=64, ntime=10, stream_seconds=0.03,
                            streaming=True)
    eng = LiveStreamEngine(ds, cfg)
    res = eng.tick(cfg)
    W = eng.window_cols  # ceil(30000/64) = 469
    assert W > cfg.ntime
    n = res.sxx_dbfs.shape[1]
    assert n <= cfg.ntime
    stride = np.diff(res.frame_starts)
    assert (stride == stride[0]).all() and stride[0] >= 64
    # newest column is always included
    lo, hi = ds.bnds[meta["channel"]]
    assert res.frame_starts[-1] + 64 == hi + 1


def test_live_tile_mode_matches_float_view(tone_capture):
    """display_tile: only a uint8 tile + median leave the device, and the
    tile equals quantizing the float snapshot."""
    from pyspectrogram_tpu.display.tile import make_tile_spec, tile_from_db
    from pyspectrogram_tpu.ops.stft import shifted_freqs, to_reference_layout

    top, meta = tone_capture
    ds = RFDataset(top)
    base = SpectrogramConfig(nfft=256, ntime=16, stream_seconds=0.01,
                             streaming=True, color_range_db=(-80.0, -10.0))
    eng = LiveStreamEngine(ds, base)
    res_f = eng.tick(base)
    res_t = eng.tick(base.replace(display_tile=True))
    assert res_t.sxx_dbfs is None and res_t.tile is not None
    assert res_t.tile.dtype == np.uint8
    freqs = shifted_freqs(256, ds.sr_dict[meta["channel"]])
    spec = make_tile_spec(freqs, base.freq_window_khz, base.color_range_db)
    # same ring, no new data: float view quantized == device tile
    want = tile_from_db(np.moveaxis(res_f.sxx_dbfs, 0, -1), spec)
    np.testing.assert_array_equal(res_t.tile, want)
    assert len(res_t.plot_freqs) == res_t.tile.shape[-1]


def test_engine_slot_reinits_on_shape_change(tone_capture):
    top, _ = tone_capture
    ds = RFDataset(top)
    slot = _EngineSlot(ds)
    cfg = SpectrogramConfig(nfft=128, ntime=8, stream_seconds=0.005,
                            streaming=True)
    r1 = slot.tick(cfg)
    e1 = slot.engine
    # display-edge knobs do NOT rebuild the ring
    slot.tick(cfg.replace(color_range_db=(-90.0, -20.0), ntime=4))
    assert slot.engine is e1
    # shape knobs do
    r2 = slot.tick(cfg.replace(nfft=256))
    assert slot.engine is not e1
    assert r1.freqs.shape == (128,) and r2.freqs.shape == (256,)
    # eps is baked into every compiled dB/tile program, so it is a
    # numerics knob: changing it must rebuild too (it used to be
    # silently ignored in streaming mode)
    e2 = slot.engine
    slot.tick(cfg.replace(nfft=256, eps=1e-9))
    assert slot.engine is not e2


def test_backlog_skip_restarts_at_tail(tmp_path):
    """Producer outruns the consumer by more than a window: the engine
    restarts at the new trailing window instead of reading stale data."""
    n0 = 30_000
    w = _growing_writer(tmp_path, n0)
    ds = RFDataset(tmp_path)
    cfg = SpectrogramConfig(nfft=64, ntime=8, stream_seconds=0.1,
                            streaming=True)
    eng = LiveStreamEngine(ds, cfg, target_block_samples=4096)
    eng.tick(cfg)
    window_samples = eng.window_cols * eng.hop
    spans = _count_reads(ds)
    # burst: 5 windows' worth of new data
    burst = 5 * window_samples
    w.rf_write(tone_signal(burst, SR, [12_500.0],
                           start_sample=n0).astype(np.complex64))
    ds.bnds_update()
    res = eng.tick(cfg)
    assert sum(spans) <= window_samples + eng.block_len  # stale data skipped
    lo, hi = ds.bnds["live"]
    # newest column is at the tail (modulo the sub-block residual)
    assert hi + 1 - (res.frame_starts[-1] + 64) < eng.block_len


def test_processor_streaming_is_incremental(tone_capture):
    """Processor-level pin: N streaming iterations over a static capture
    read the window ONCE (the reference reads it N times)."""
    from pyspectrogram_tpu.runtime import (
        ProcessorCallbacks,
        SpectrogramProcessor,
    )

    top, meta = tone_capture
    events = []
    proc = SpectrogramProcessor(
        "streaming", top, tab_id=5,
        config=SpectrogramConfig(nfft=128, ntime=8, stream_seconds=0.01),
        callbacks=ProcessorCallbacks(on_iterated=events.append),
        streaming_sleep=0.0, max_iterations=5,
    )
    spans = _count_reads(proc.ds)
    proc.run()
    assert len(events) == 5
    window_samples = proc._live.engine.window_cols * proc._live.engine.hop
    # static capture: everything after the initial fill reads nothing
    assert sum(spans) <= window_samples + proc._live.engine.block_len
    # all five refreshes still produced full payloads from the ring,
    # including the column-validity mask (gap flags reach clients)
    assert all(e.sxx_med_dbfs.shape == (128, 2) for e in events)
    assert all(e.mask is not None and e.mask.all() for e in events)


def test_live_gap_columns_flagged(tmp_path):
    """Columns computed over zero-filled gap samples carry mask=False
    (the batch path's gap semantics; the reference crashed on gaps)."""
    n0 = 20_000
    w = _growing_writer(tmp_path, n0)
    # leave a 4_000-sample hole, then continue (global_index > head)
    gap, n1 = 4_000, 16_000
    w.rf_write(tone_signal(n1, SR, [12_500.0],
                           start_sample=n0 + gap).astype(np.complex64),
               global_index=START + n0 + gap)
    ds = RFDataset(tmp_path)
    cfg = SpectrogramConfig(nfft=64, ntime=1000, stream_seconds=0.4,
                            streaming=True)
    eng = LiveStreamEngine(ds, cfg, target_block_samples=4096)
    res = eng.tick(cfg)
    assert res.mask is not None and res.mask.shape == res.times.shape
    # window (40000 samples) covers the gap: some columns invalid
    assert (~res.mask).any() and res.mask.any()
    # flagged columns are exactly those whose frame touches the hole
    hole_lo, hole_hi = START + n0, START + n0 + gap
    overlaps = ((res.frame_starts < hole_hi)
                & (res.frame_starts + 64 > hole_lo))
    np.testing.assert_array_equal(~res.mask, overlaps)


def test_live_ring_wrap_long_run(tmp_path):
    """Many wraps of the ring: the col -> storage-row mapping (and the
    host mask shadow) stay correct long after total_cols exceeds
    ring_len (the rotating-storage arithmetic is the subtle part)."""
    import jax.numpy as jnp

    from pyspectrogram_tpu.models.sti import assemble_device_block
    from pyspectrogram_tpu.ops import stft

    n0 = 12_800
    w = _growing_writer(tmp_path, n0)
    ds = RFDataset(tmp_path)
    # window 0.04 s -> 62.5 cols at nfft 64 -> W=63, ring 64; ntime >= W
    cfg = SpectrogramConfig(nfft=64, ntime=64, stream_seconds=0.04,
                            streaming=True)
    eng = LiveStreamEngine(ds, cfg, target_block_samples=2048)
    eng.tick(cfg)
    total_written = n0
    for _ in range(6):  # ~5x the ring length in total columns
        delta = 3_200
        w.rf_write(tone_signal(delta, SR, [12_500.0],
                               start_sample=total_written)
                   .astype(np.complex64))
        total_written += delta
        ds.bnds_update()
        res = eng.tick(cfg)
    assert eng.total_cols > 4 * eng.sti.ring_len  # wrapped repeatedly
    assert res.mask.all()
    assert np.all(np.diff(res.frame_starts) == eng.hop * 1)
    # every displayed column equals a from-scratch recompute of the same
    # frames — the mapping survived the wraps
    chan = "live"
    fn = stft.make_sti_fn_pm(nfft=64, nint=1, mode=cfg.mode,
                             window=cfg.window, ref=ds.ref_dict[chan],
                             contiguous=True)
    pm, starts_rel, _ = assemble_device_block(
        ds, chan, None, res.frame_starts, 64)
    out = fn(jnp.asarray(pm), jnp.asarray(starts_rel))
    want = stft.to_reference_layout(
        np.asarray(out["sxx_dbfs"])[: len(res.frame_starts)])
    np.testing.assert_allclose(res.sxx_dbfs, want, atol=1e-4)


def test_fillup_median_span_rides_a_ladder(tmp_path):
    """While the window FILLS on a young capture, every tick has a new
    total column count — but the device median programs are compiled per
    static count, and each compile costs seconds. The engine must
    quantize the fill-up median span to a geometric ladder (floor-pow2,
    then exactly W) so the number of compiled refresh programs stays
    O(log W), not O(ticks)."""
    n0 = 8_192
    w = _growing_writer(tmp_path, n0)
    ds = RFDataset(tmp_path)
    # window 0.5 s -> W = ceil(50000/64) = 782 cols; blocks of 64 cols
    cfg = SpectrogramConfig(nfft=64, ntime=16, stream_seconds=0.5,
                            streaming=True)
    eng = LiveStreamEngine(ds, cfg, target_block_samples=4096)
    total_written = n0
    n_ticks = 0
    while eng.total_cols < eng.window_cols + 2 * eng.cols_per_block:
        eng.tick(cfg)
        n_ticks += 1
        delta = 4_096
        w.rf_write(tone_signal(delta, SR, [12_500.0],
                               start_sample=total_written)
                   .astype(np.complex64))
        total_written += delta
        ds.bnds_update()
    assert n_ticks >= 10  # the fill-up really spanned many distinct totals
    meds = sorted(k[4] for k in eng.sti._tile_fns if k[0] == "refresh")
    # floor-pow2 ladder during fill, exactly W once full — never one
    # program per tick
    W = eng.window_cols
    assert len(meds) <= int(np.log2(W)) + 2
    for n in meds:
        assert n == W or (n & (n - 1)) == 0, meds
    assert meds[-1] == W  # steady state reached: exact full-window median


def test_checkpoint_resume_continues_stream(tmp_path):
    """A saved live session resumes mid-stream: the rebuilt engine reads
    only the samples appended after the checkpoint, and its view stays
    bit-identical to an engine that was never interrupted."""
    n0 = 60_000
    cap = tmp_path / "cap"
    w = _growing_writer(cap, n0)
    cfg = SpectrogramConfig(nfft=64, ntime=16, stream_seconds=0.5,
                            streaming=True)
    ds_a = RFDataset(cap)
    eng_a = LiveStreamEngine(ds_a, cfg, target_block_samples=4096)
    eng_a.tick(cfg)
    ck = eng_a.save(tmp_path / "live.ckpt")

    delta = 9_000
    w.rf_write(tone_signal(delta, SR, [12_500.0],
                           start_sample=n0).astype(np.complex64))
    ds_a.bnds_update()

    ds_b = RFDataset(cap)
    eng_b = LiveStreamEngine.resume(ds_b, cfg, ck)
    assert eng_b.total_cols == eng_a.total_cols
    assert eng_b.next_sample == eng_a.next_sample
    assert eng_b.cols_per_block == eng_a.cols_per_block
    spans = _count_reads(ds_b)
    res_b = eng_b.tick(cfg)
    res_a = eng_a.tick(cfg)
    # O(delta) from the saved cursor: pre-checkpoint samples never re-read
    assert sum(spans) <= delta + eng_b.block_len
    np.testing.assert_array_equal(res_b.sxx_dbfs, res_a.sxx_dbfs)
    np.testing.assert_array_equal(res_b.sxx_med_dbfs, res_a.sxx_med_dbfs)
    np.testing.assert_array_equal(res_b.frame_starts, res_a.frame_starts)
    np.testing.assert_array_equal(res_b.mask, res_a.mask)


def test_checkpoint_resume_refuses_shape_change(tmp_path):
    """Resuming under different shape knobs must fail loudly — the ring's
    compiled programs and geometry are keyed to the saved signature."""
    cap = tmp_path / "cap"
    _growing_writer(cap, 60_000)
    ds = RFDataset(cap)
    cfg = SpectrogramConfig(nfft=64, ntime=16, stream_seconds=0.5,
                            streaming=True)
    eng = LiveStreamEngine(ds, cfg, target_block_samples=4096)
    eng.tick(cfg)
    ck = eng.save(tmp_path / "live.ckpt")
    with pytest.raises(ValueError, match="shape knobs"):
        LiveStreamEngine.resume(ds, cfg.replace(nfft=128), ck)
    # a session checkpoint is not a live-stream checkpoint
    from pyspectrogram_tpu.runtime import checkpoint

    p = checkpoint.save_session(tmp_path / "sess.npz", cap, cfg)
    with pytest.raises((KeyError, ValueError)):
        LiveStreamEngine.resume(ds, cfg, p)  # no ring payload in a session


def test_checkpoint_resume_on_mesh(tmp_path):
    """A chan-sharded live session resumes sharded: the restored
    ring/carry are re-placed under the mesh layout, and the resumed view
    equals the pre-checkpoint one."""
    from pyspectrogram_tpu.io.synthetic import write_capture
    from pyspectrogram_tpu.parallel import make_mesh

    cap = tmp_path / "cap"
    write_capture(cap, channel="m", kind="tone", n_samples=40_000,
                  sample_rate_numerator=SR, num_subchannels=4)
    cfg = SpectrogramConfig(nfft=64, ntime=16, stream_seconds=0.2,
                            streaming=True)
    mesh = make_mesh(time_parallel=2, chan_parallel=4)
    ds = RFDataset(cap)
    eng = LiveStreamEngine(ds, cfg, mesh=mesh, target_block_samples=4096)
    res0 = eng.tick(cfg)
    assert res0 is not None
    ck = eng.save(tmp_path / "live.ckpt")

    eng2 = LiveStreamEngine.resume(RFDataset(cap), cfg, ck, mesh=mesh)
    assert eng2.next_sample == eng.next_sample
    carry_sh, ring_sh, _ = eng2.sti._shardings()
    assert eng2.state.ring.sharding == ring_sh
    assert eng2.state.carry.sharding == carry_sh
    # no new data: the ring view is unchanged. The resumed tick pushed
    # no blocks, so it ALSO surfaces the pending tail (complete columns
    # that never filled a push block) as extra rows past res0's span.
    res1 = eng2.tick(cfg)
    n0 = res0.sxx_dbfs.shape[1]
    np.testing.assert_allclose(res1.sxx_dbfs[:, :n0], res0.sxx_dbfs,
                               atol=1e-5)
    np.testing.assert_allclose(res1.sxx_med_dbfs, res0.sxx_med_dbfs,
                               atol=1e-5)
    np.testing.assert_array_equal(res1.frame_starts[:n0],
                                  res0.frame_starts)
    assert (res1.frame_starts[n0:] > res0.frame_starts[-1]).all()
    assert (res1.frame_starts[n0:] >= eng2.next_sample).all()


def test_checkpoint_resume_refuses_torn_and_wrong_geometry(tmp_path):
    """resume() rejects (a) a checkpoint whose host cursor disagrees with
    the device column count (saved mid-tick) and (b) a same-config
    checkpoint from a dataset with different subchannel geometry."""
    from pyspectrogram_tpu.io.synthetic import write_capture

    cap = tmp_path / "cap"
    _growing_writer(cap, 60_000)
    ds = RFDataset(cap)
    cfg = SpectrogramConfig(nfft=64, ntime=16, stream_seconds=0.5,
                            streaming=True)
    eng = LiveStreamEngine(ds, cfg, target_block_samples=4096)
    eng.tick(cfg)
    ck = eng.save(tmp_path / "live.ckpt")

    # (a) torn: host cursor one block behind the device counter
    z = dict(np.load(ck, allow_pickle=False))
    z["total_cols"] = z["total_cols"] + eng.cols_per_block
    torn = tmp_path / "torn.npz"
    np.savez(torn, **z)
    with pytest.raises(ValueError, match="torn checkpoint"):
        LiveStreamEngine.resume(ds, cfg, torn)

    # (b) same channel name + config, but 2 subchannels instead of 1
    cap2 = tmp_path / "cap2"
    write_capture(cap2, channel="live", kind="tone", n_samples=60_000,
                  sample_rate_numerator=SR, num_subchannels=2)
    with pytest.raises(ValueError, match="geometry mismatch"):
        LiveStreamEngine.resume(RFDataset(cap2), cfg, ck)


def test_live_int16_capture_normalization(tmp_path):
    """Live engine over an int16-compound capture: the storage dtype rides
    the same assemble path as batch, and the dBFS normalization applies
    the int16 half-bit rule (ref 2^15.5, reference: drfProc.py:199-201) —
    a 2^14-amplitude tone reads 20*log10(2^14 / 2^15.5) = -9.03 dBFS."""
    from pyspectrogram_tpu.io.synthetic import write_capture

    i16 = np.dtype([("r", np.int16), ("i", np.int16)])
    write_capture(tmp_path / "cap", channel="c", kind="tone",
                  n_samples=120_000, sample_rate_numerator=SR, dtype=i16)
    ds = RFDataset(tmp_path / "cap")
    cfg = SpectrogramConfig(nfft=256, ntime=8, stream_seconds=0.2,
                            streaming=True)
    eng = LiveStreamEngine(ds, cfg)
    res = eng.tick(cfg)
    assert res.sxx_dbfs.shape == (256, 8, 1)
    np.testing.assert_allclose(float(res.sxx_med_dbfs.max()),
                               20 * np.log10(2**14 / 2**15.5), atol=0.05)


def test_overlap_hop_short_capture_still_displays(tmp_path):
    """Round-5 review finding: cols_per_block was derived carry-blind
    ((hi-lo+1)//hop), so an overlap-hop capture that stopped growing just
    short of carry_len + k*hop samples could never push a block — and
    with total_cols == 0, tick() returned None forever despite complete
    columns existing. The frame-aware derivation guarantees the initial
    capture always fits at least one block once it holds one frame."""
    n0 = 1_100                              # frame 64, hop 16, carry 48
    _growing_writer(tmp_path, n0)
    ds = RFDataset(tmp_path)
    cfg = SpectrogramConfig(nfft=64, nint=1, ntime=1000, hop=16,
                            stream_seconds=0.1, streaming=True)
    eng = LiveStreamEngine(ds, cfg, target_block_samples=4096)
    # carry-aware: one whole block fits the initial capture
    assert eng.carry_len == 48
    assert eng.carry_len + eng.cols_per_block * eng.hop <= n0
    res = eng.tick(cfg)
    assert res is not None                  # carry-blind k: None forever
    # ring + tail together show every complete hop-spaced column: gapless
    # hop spacing, and the last column's frame ends within one hop of the
    # capture end
    assert np.all(np.diff(res.frame_starts) == 16)
    lo, hi = ds.bnds["live"]
    assert 0 <= (hi + 1) - (int(res.frame_starts[-1]) + 64) < 16


def test_tail_columns_surface_when_writer_stops(tmp_path):
    """Complete columns that never fill a whole push block still surface
    in the view once blocks stop flowing (round-4 review finding: the
    block-granular engine permanently hid up to cols_per_block-1 columns
    of a capture that stopped growing, where the reference's
    recompute-the-window loop showed all available data)."""
    import jax.numpy as jnp

    from pyspectrogram_tpu.ops import stft

    n0 = 8_192          # 128 cols at hop 64
    w = _growing_writer(tmp_path, n0)
    ds = RFDataset(tmp_path)
    cfg = SpectrogramConfig(nfft=64, ntime=1000, stream_seconds=0.4,
                            streaming=True)
    eng = LiveStreamEngine(ds, cfg, target_block_samples=4096)  # k = 64
    assert eng.cols_per_block == 64
    res0 = eng.tick(cfg)                 # pushes 2 blocks, no tail
    assert res0.sxx_dbfs.shape[1] == 128

    # writer appends 37 columns' worth and stops: < 1 block pending
    tail_cols = 37
    w.rf_write(tone_signal(tail_cols * 64, SR, [12_500.0],
                           start_sample=n0).astype(np.complex64))
    ds.bnds_update()
    res1 = eng.tick(cfg)                 # no block fits -> tail view
    assert eng._tail_pending == tail_cols
    assert res1.sxx_dbfs.shape[1] == 128 + tail_cols
    # every column of the capture is now displayed, up to the last hop
    lo, hi = ds.bnds["live"]
    assert res1.frame_starts[-1] + 64 == hi + 1
    assert np.all(np.diff(res1.frame_starts) == 64)
    # tail rows equal a from-scratch recompute over the same frames
    from pyspectrogram_tpu.models.sti import assemble_device_block

    fn = stft.make_sti_fn_pm(nfft=64, nint=1, mode=cfg.mode,
                             window=cfg.window, ref=ds.ref_dict["live"],
                             contiguous=True)
    pm, starts_rel, _ = assemble_device_block(
        ds, "live", None, res1.frame_starts[128:], 64)
    out = fn(jnp.asarray(pm), jnp.asarray(starts_rel))
    want = stft.to_reference_layout(np.asarray(out["sxx_dbfs"]))
    np.testing.assert_allclose(res1.sxx_dbfs[:, 128:], want, atol=1e-4)
    # the median stays ring-only (tail columns join once their block
    # completes) and the cursor still excludes the tail: a checkpoint
    # resumes by re-reading these samples
    assert eng.next_sample == START + n0
    # idle tick: the cached tail is reused without re-reading
    reads_before = eng.tail_samples_read
    res2 = eng.tick(cfg)
    assert eng.tail_samples_read == reads_before
    np.testing.assert_allclose(res2.sxx_dbfs, res1.sxx_dbfs, atol=0)

    # writer completes the block: the tail enters the ring and the
    # ring-computed columns match what the tail view showed
    w.rf_write(tone_signal((64 - tail_cols) * 64, SR, [12_500.0],
                           start_sample=n0 + tail_cols * 64)
               .astype(np.complex64))
    ds.bnds_update()
    res3 = eng.tick(cfg)                 # one block pushed, no tail
    assert eng._tail_pending == 0
    assert res3.sxx_dbfs.shape[1] == 128 + 64
    np.testing.assert_allclose(res3.sxx_dbfs[:, 128:128 + tail_cols],
                               res1.sxx_dbfs[:, 128:], atol=1e-4)


def test_tail_columns_tile_mode(tmp_path):
    """Tile-mode tail rows ride the same quantization spec as the ring
    snapshot: uint8 rows appended to the device tile."""
    from pyspectrogram_tpu.display.tile import make_tile_spec

    n0 = 8_192
    w = _growing_writer(tmp_path, n0)
    ds = RFDataset(tmp_path)
    cfg = SpectrogramConfig(nfft=64, ntime=1000, stream_seconds=0.4,
                            streaming=True, display_tile=True)
    cfg_f = cfg.replace(display_tile=False)
    eng = LiveStreamEngine(ds, cfg, target_block_samples=4096)
    eng.tick(cfg)
    w.rf_write(tone_signal(21 * 64, SR, [12_500.0],
                           start_sample=n0).astype(np.complex64))
    ds.bnds_update()
    res = eng.tick(cfg)
    assert res.tile is not None and res.tile.dtype == np.uint8
    assert res.tile.shape[0] == 128 + 21
    assert res.mask.shape == res.times.shape

    # quantizing the float tail independently gives the same uint8 rows
    eng2 = LiveStreamEngine(ds, cfg_f, target_block_samples=4096)
    eng2.tick(cfg_f)
    resf = eng2.tick(cfg_f)
    from pyspectrogram_tpu.display.tile import tile_from_db

    spec = make_tile_spec(resf.freqs, cfg.freq_window_khz,
                          cfg.color_range_db)
    want = tile_from_db(np.moveaxis(resf.sxx_dbfs[:, 128:], 0, -1), spec)
    np.testing.assert_array_equal(res.tile[128:], want)


def test_tail_surfaces_while_blocks_flow(tmp_path):
    """Round-5 pin: under CONTINUOUS writing, the newest complete column
    appears in the same tick it completes — even on ticks that also push
    whole blocks (round 4 gated the tail view to block-less ticks, hiding
    up to cols_per_block-1 of the newest columns in steady state)."""
    import jax.numpy as jnp

    from pyspectrogram_tpu.models.sti import assemble_device_block
    from pyspectrogram_tpu.ops import stft

    n0 = 8_192          # 128 cols at hop 64
    w = _growing_writer(tmp_path, n0)
    ds = RFDataset(tmp_path)
    cfg = SpectrogramConfig(nfft=64, ntime=1000, stream_seconds=0.4,
                            streaming=True)
    eng = LiveStreamEngine(ds, cfg, target_block_samples=4096)  # k = 64
    eng.tick(cfg)

    # writer appends one whole block PLUS a partial tail, then the tick
    # runs: the block enters the ring AND the 13 tail columns display
    tail_cols = 13
    w.rf_write(tone_signal((64 + tail_cols) * 64, SR, [12_500.0],
                           start_sample=n0).astype(np.complex64))
    ds.bnds_update()
    res = eng.tick(cfg)
    assert eng._tail_pending == tail_cols
    assert res.sxx_dbfs.shape[1] == 128 + 64 + tail_cols
    # every complete column of the capture is visible this tick
    lo, hi = ds.bnds["live"]
    assert res.frame_starts[-1] + 64 == hi + 1
    assert np.all(np.diff(res.frame_starts) == 64)
    # tail rows equal a from-scratch recompute over the same frames
    fn = stft.make_sti_fn_pm(nfft=64, nint=1, mode=cfg.mode,
                             window=cfg.window, ref=ds.ref_dict["live"],
                             contiguous=True)
    pm, starts_rel, _ = assemble_device_block(
        ds, "live", None, res.frame_starts[-tail_cols:], 64)
    out = fn(jnp.asarray(pm), jnp.asarray(starts_rel))
    want = stft.to_reference_layout(np.asarray(out["sxx_dbfs"]))
    np.testing.assert_allclose(res.sxx_dbfs[:, -tail_cols:], want,
                               atol=1e-4)
    # the cursor still excludes the tail (checkpoints re-read it)
    assert eng.next_sample == START + n0 + 64 * 64


@pytest.mark.parametrize("nfft,nint,hop", [
    (256, 1, 128),   # half-frame overlap
    (256, 1, 64),    # 4x overlap
    (128, 2, 128),   # overlap across Welch segment boundaries
    (128, 2, 96),    # non-divisor hop, nint > 1
])
def test_overlap_hop_columns_match_oracle(tone_capture, nfft, nint, hop):
    """cfg.hop < nfft*nint runs the live engine in overlap-save mode:
    columns start every hop samples and overlap by frame_len - hop.
    Every displayed column — carry-seeded first column, ring columns,
    tail columns — equals a from-scratch STI over the same frame
    starts."""
    import jax.numpy as jnp

    from pyspectrogram_tpu.models.sti import assemble_device_block
    from pyspectrogram_tpu.ops import stft

    top, meta = tone_capture
    ds = RFDataset(top)
    frame_len = nfft * nint
    cfg = SpectrogramConfig(nfft=nfft, nint=nint, ntime=100,
                            stream_seconds=0.005, hop=hop, streaming=True)
    eng = LiveStreamEngine(ds, cfg)
    assert eng.hop == hop and eng.carry_len == frame_len - hop
    res = eng.tick(cfg)
    assert res is not None
    assert np.all(np.diff(res.frame_starts) == hop)  # overlapping starts
    chan = meta["channel"]
    lo, hi = ds.bnds[chan]
    # the newest complete column surfaces and its frame ends at the tail
    assert res.frame_starts[-1] + frame_len == hi + 1

    fn = stft.make_sti_fn_pm(
        nfft=nfft, nint=nint, mode=cfg.mode, window=cfg.window,
        ref=ds.ref_dict[chan], contiguous=True)
    pm, starts_rel, _ = assemble_device_block(
        ds, chan, None, res.frame_starts, frame_len)
    out = fn(jnp.asarray(pm), jnp.asarray(starts_rel))
    n = len(res.frame_starts)
    want = stft.to_reference_layout(np.asarray(out["sxx_dbfs"])[:n])
    np.testing.assert_allclose(res.sxx_dbfs, want, atol=1e-4)
    want_med = np.moveaxis(np.asarray(out["sxx_med_dbfs"]), -1, 0)
    # the ring median spans only pushed columns (tail joins on block
    # completion), so compare against the ring-resident span
    assert res.sxx_med_dbfs.shape == want_med.shape


def test_overlap_checkpoint_resume_and_signature(tmp_path):
    """The hop is a shape knob: checkpoints record it, a resume with a
    different hop is refused, and a same-hop resume continues the
    overlapped stream."""
    w = _growing_writer(tmp_path, 40_000)
    ds = RFDataset(tmp_path)
    cfg = SpectrogramConfig(nfft=64, ntime=64, stream_seconds=0.02,
                            hop=32, streaming=True)
    eng = LiveStreamEngine(ds, cfg, target_block_samples=2048)
    r1 = eng.tick(cfg)
    assert r1 is not None
    path = tmp_path / "st.npz"
    eng.save(path)
    with pytest.raises(ValueError, match="shape knobs"):
        LiveStreamEngine.resume(ds, cfg.replace(hop=64), path)
    eng2 = LiveStreamEngine.resume(ds, cfg, path)
    assert eng2.hop == 32 and eng2.next_sample == eng.next_sample
    w.rf_write(tone_signal(4096, SR, [12_500.0],
                           start_sample=40_000).astype(np.complex64))
    ds.bnds_update()
    r2 = eng2.tick(cfg)
    assert r2.frame_starts[-1] > r1.frame_starts[-1]
    assert np.all(np.diff(r2.frame_starts) == 32)


def test_overlap_gap_flags_touching_columns(tmp_path):
    """With overlapping hops a written gap invalidates EVERY column whose
    frame touches it (the sliding-window mask), not just the column whose
    hop slice contains it."""
    from pyspectrogram_tpu.io.synthetic import write_capture

    write_capture(tmp_path, channel="g", kind="tone", n_samples=20_000,
                  sample_rate_numerator=SR, gap=(15_000, 300))
    ds = RFDataset(tmp_path)
    cfg = SpectrogramConfig(nfft=128, nint=1, ntime=200,
                            stream_seconds=0.1, hop=64, streaming=True)
    eng = LiveStreamEngine(ds, cfg)
    res = eng.tick(cfg)
    lo, _ = ds.bnds["g"]
    gap_lo, gap_hi = lo + 15_000, lo + 15_300
    starts = res.frame_starts
    want_bad = (starts < gap_hi) & (starts + 128 > gap_lo)
    assert want_bad.sum() > 300 // 64  # overlap widens the flagged span
    np.testing.assert_array_equal(~res.mask, want_bad)


def test_overlap_hop_on_mesh_matches_single_device(tmp_path):
    """A chan-sharded overlap-save stream seeds its carry under the mesh
    layout (live.py _seed_carry's device_put branch) and every displayed
    column — carry-seeded first column included — equals the
    single-device engine's over the same capture."""
    from pyspectrogram_tpu.io.synthetic import write_capture
    from pyspectrogram_tpu.parallel import make_mesh

    cap = tmp_path / "cap"
    write_capture(cap, channel="m", kind="tone", n_samples=40_000,
                  sample_rate_numerator=SR, num_subchannels=4)
    cfg = SpectrogramConfig(nfft=64, ntime=200, stream_seconds=0.05,
                            hop=32, streaming=True)
    mesh = make_mesh(time_parallel=2, chan_parallel=4)
    eng_m = LiveStreamEngine(RFDataset(cap), cfg, mesh=mesh,
                             target_block_samples=4096)
    assert eng_m.carry_len == 32
    carry_sh, _, _ = eng_m.sti._shardings()
    assert eng_m.state.carry.sharding == carry_sh  # seeded carry is placed
    res_m = eng_m.tick(cfg)
    assert res_m is not None

    eng_1 = LiveStreamEngine(RFDataset(cap), cfg, target_block_samples=4096)
    res_1 = eng_1.tick(cfg)
    np.testing.assert_array_equal(res_m.frame_starts, res_1.frame_starts)
    assert np.all(np.diff(res_m.frame_starts) == 32)
    np.testing.assert_allclose(res_m.sxx_dbfs, res_1.sxx_dbfs, atol=1e-4)
    np.testing.assert_allclose(res_m.sxx_med_dbfs, res_1.sxx_med_dbfs,
                               atol=1e-4)
    np.testing.assert_array_equal(res_m.mask, res_1.mask)


def test_resume_accepts_pre_hop_checkpoint(tmp_path):
    """Checkpoints saved before the hop signature entry (8-entry
    signatures, rounds <= 4) resume as the contiguous streams they were,
    instead of being refused by the length mismatch."""
    import json

    _growing_writer(tmp_path, 40_000)
    ds = RFDataset(tmp_path)
    cfg = SpectrogramConfig(nfft=64, ntime=16, stream_seconds=0.02,
                            streaming=True)
    eng = LiveStreamEngine(ds, cfg, target_block_samples=2048)
    eng.tick(cfg)
    path = eng.save(tmp_path / "st.npz")
    # forge the pre-round-5 header: drop the signature's hop entry
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    header = json.loads(bytes(arrays["header"].tobytes()).decode())
    assert len(header["meta"]["signature"]) == 9
    header["meta"]["signature"] = header["meta"]["signature"][:8]
    arrays["header"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
    np.savez(path, **arrays)

    eng2 = LiveStreamEngine.resume(ds, cfg, path)
    assert eng2.hop == 64 and eng2.carry_len == 0
    assert eng2.next_sample == eng.next_sample
