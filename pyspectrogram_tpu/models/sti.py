"""STI pipeline: one request -> (times, freqs, sxx_dbfs, sxx_med_dbfs).

This is the array-in/array-out core the reference exposes implicitly through
its Qt signal payloads (``iterated(i, tabID, times, freqs, sxx_dbfs,
sxx_med_dbfs)``, reference: drfProc.py:458-461, emitted at
drfProc.py:312-314). The pipeline:

  host: pick channel + time window -> exact time->sample conversion ->
        coalesced HDF5 frame reads assembled into a compact plane-packed
        device block (raw integer data ships unconverted)
  device (jit): gather -> window -> FFT -> |X|^2 -> (Welch avg) ->
        fftshift -> median -> dB
  host: per-column datetimes, fftshifted freqs, reference-layout views
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np

from pyspectrogram_tpu.io.reader import RFDataset
from pyspectrogram_tpu.io.time_util import samples_to_datetime64, time_to_sample
from pyspectrogram_tpu.ops import stft
from pyspectrogram_tpu.utils.config import (
    SpectrogramConfig,
    resolve_time_span,
)


@dataclasses.dataclass(frozen=True)
class StiResult:
    """Payload-parity result (reference: drfProc.py:303-314)."""

    iteration: int
    times: np.ndarray          # (ntime,) datetime64/us-resolution datetimes
    freqs: np.ndarray          # (nfft,) Hz, fftshifted
    #: (nfft, ntime, nsub) reference layout — None in display-tile mode,
    #: where the float spectra intentionally never leave the device
    sxx_dbfs: Optional[np.ndarray]
    sxx_med_dbfs: np.ndarray   # (nfft, nsub)
    sample_rate: Fraction
    frame_starts: np.ndarray   # (ntime,) absolute sample indices
    mask: Optional[np.ndarray] = None  # (ntime,) column validity (gaps)
    #: display-tile mode outputs (see display.tile): uint8 level indices
    #: (ntime, nsub, nplot) + the plot frequency axis they correspond to
    tile: Optional[np.ndarray] = None
    plot_freqs: Optional[np.ndarray] = None

    @property
    def sxx_time_major(self) -> np.ndarray:
        """(ntime, nsub, nfft) device-native layout view."""
        if self.sxx_dbfs is None:
            raise ValueError(
                "no float spectra in display-tile mode (sxx_dbfs is None; "
                "the floats stay on device) — use result.tile, or compute "
                "with display_tile=False")
        return np.moveaxis(self.sxx_dbfs, 0, -1)


def assemble_device_block(
    ds: RFDataset, chan: str, isub: Optional[int], n_st: np.ndarray,
    frame_len: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read ``len(n_st)`` frames into one plane-major device buffer.

    Returns (samples_pm, starts_rel, col_mask):
      samples_pm: (nsub*2, ntime*frame_len) float32 (or int16 for raw
                  integer channels — dBFS normalization happens on-device
                  via the folded power scale);
      starts_rel: (ntime,) int32 offsets into the buffer (t*frame_len);
      col_mask:   (ntime,) True where the frame had no data gaps.

    Replaces the reference's per-column ``read_vector`` loop
    (reference: drfProc.py:161-164) with coalesced bulk reads; the frame
    slicing + plane deinterleave runs in the native C++ ingest kernel when
    available (pyspectrogram_tpu.native.ingest).
    """
    from pyspectrogram_tpu.native import ingest

    reader = ds.reader
    ntime = len(n_st)
    lo = int(n_st[0])
    hi = int(n_st[-1]) + frame_len
    dense_span = hi - lo
    coalesce = dense_span <= 2 * frame_len * ntime

    if coalesce:
        raw, mask = reader.read_vector_raw(lo, dense_span, chan, return_mask=True)
        rel = np.asarray(n_st, np.int64) - lo
        # gap-count prefix sum (runtime.live._col_valid's form, here over
        # the non-uniform linspace starts): one O(span) cumsum, not an
        # O(ntime) Python loop of slice .all() calls — at the reference's
        # ntime = 1e5 ceiling that loop is pure interpreter overhead on
        # the per-tick host path
        bad = np.concatenate([[0], np.cumsum(~mask)])
        fmask = bad[rel + frame_len] - bad[rel] == 0
    else:
        frames, fmask = [], []
        for s in n_st:
            r, m = reader.read_vector_raw(int(s), frame_len, chan,
                                          return_mask=True)
            frames.append(r)
            fmask.append(m.all())
        raw = np.concatenate(frames, axis=0)
        rel = np.arange(ntime, dtype=np.int64) * frame_len
    if isub is not None:
        raw = raw[:, isub : isub + 1]
    raw = _assemblable(raw)
    samples_pm = ingest.assemble_plane_major(raw, rel, frame_len)
    starts_rel = np.arange(ntime, dtype=np.int32) * frame_len
    return samples_pm, starts_rel, np.asarray(fmask, bool)


#: requests whose sample buffer is at least this large assemble through a
#: chunked PrefetchFeeder (io.ingest): the host HDF5 read + native plane
#: packing of chunk k+1 overlaps the host->device transfer of chunk k.
#: Below it the pipeline overhead (thread + device-side concat pass)
#: outweighs the overlap (a threshold set before any GPU measurement).
PREFETCH_MIN_BYTES = 32 << 20
#: chunks per prefetched request: enough that read/transfer overlap,
#: few enough that the per-chunk dispatch overhead stays negligible
PREFETCH_CHUNKS = 4


def assemble_device_block_prefetch(
    ds: RFDataset, chan: str, isub: Optional[int], n_st: np.ndarray,
    frame_len: int, n_chunks: int = PREFETCH_CHUNKS,
):
    """Chunked, overlapped variant of :func:`assemble_device_block`.

    Splits the ``ntime`` columns into ``n_chunks`` contiguous ranges and
    runs each range's read+assemble on a PrefetchFeeder background thread
    (io.ingest), device_put included — so the HDF5 read of chunk k+1
    overlaps the host->device transfer of chunk k (the pipeline-parallel
    ingest the reference's read->compute thread split approximates,
    SURVEY.md section 2.3 PP row). Returns (chunks, starts_rel, col_mask)
    with ``chunks`` a list of on-device (nsub*2, cols_i*frame_len) arrays
    to be concatenated on device (order preserved).
    """
    from pyspectrogram_tpu.io.ingest import PrefetchFeeder

    ntime = len(n_st)
    n_chunks = max(1, min(int(n_chunks), ntime))
    edges = np.linspace(0, ntime, n_chunks + 1, dtype=np.int64)
    masks: list = [None] * n_chunks

    def produce(i: int):
        lo, hi = int(edges[i]), int(edges[i + 1])
        pm, _, fmask = assemble_device_block(ds, chan, isub, n_st[lo:hi],
                                             frame_len)
        masks[i] = fmask
        return pm

    with PrefetchFeeder(produce, n_chunks, depth=2) as feeder:
        chunks = list(feeder)
    starts_rel = np.arange(ntime, dtype=np.int32) * frame_len
    return chunks, starts_rel, np.concatenate(masks)


def _assemblable(raw: np.ndarray) -> np.ndarray:
    """Coerce a storage-dtype block to a layout the ingest kernels accept:
    complex64, int16-compound (kept raw: the device program normalizes),
    or — for every other dtype, incl. compound int8/int32/int64 —
    complex64 via the field-wise converter (ingest.to_complex64)."""
    from pyspectrogram_tpu.native import ingest

    if raw.dtype.names is not None and raw.dtype["r"] == np.int16:
        return raw
    return ingest.to_complex64(raw)


#: with a mesh, the smallest transform that may run as the distributed
#: 4-step FFT (parallel.big_sti, one all-to-all per segment). The tier is
#: taken only where column sharding cannot place the request — subchannel
#: plane pairs that do not divide over the chan axis (StiPipeline.
#: _use_bigfft); below this size such a request is refused instead, as
#: the 4-step split needs a transform large enough to spread.
BIGFFT_THRESHOLD = 1 << 18


class StiPipeline:
    """Reusable request executor over one dataset.

    Jitted device programs are cached per (nfft, nint, mode, window, ref)
    via make_sti_fn's cache, so settings changes recompile only when a
    static shape/knob actually changes.

    Pass ``mesh`` (a jax.sharding.Mesh from parallel.make_mesh) to run each
    request over multiple devices. Dispatch: STI columns shard over
    ``time`` and subchannels over ``chan`` whenever nsub divides by the
    chan-axis size (ntime pads automatically); otherwise, at/above
    BIGFFT_THRESHOLD, the FFT itself distributes over ``time``
    (parallel.big_sti).
    """

    def __init__(self, dataset: RFDataset, config: SpectrogramConfig,
                 mesh=None, bigfft_threshold: int = BIGFFT_THRESHOLD):
        self.ds = dataset
        self.config = config
        self.mesh = mesh
        self.bigfft_threshold = bigfft_threshold
        self._iteration = -1

    def channel_of(self, config: SpectrogramConfig) -> Tuple[str, Optional[int]]:
        entry = config.channel or self.ds.channels[0]
        return self.ds._split_entry(entry)

    def _resolve_span(self, cfg: SpectrogramConfig, chan: str, sr: Fraction,
                      sample_span: Optional[Tuple[int, int]] = None,
                      ) -> Tuple[int, int]:
        """The request's effective absolute sample span under the CURRENT
        bounds (no refresh here — callers refresh first)."""
        if sample_span is not None:
            # sti_frame_starts spreads ntime starts over
            # [st, en - frame_len]: feeding last_start + frame_len back
            # reproduces the saved run's linspace endpoints exactly
            return (int(sample_span[0]),
                    int(sample_span[1]) + cfg.nfft * cfg.nint)
        if cfg.streaming:
            # trailing window anchored at the SELECTED CHANNEL's data
            # end (the reference anchors at the wall clock,
            # drfProc.py:291-293, which shows nothing for a
            # paused/short capture; the dataset-global time_bnds
            # would anchor past a channel that lags another channel's
            # capture and show only void); clamping the start to the
            # channel's data start keeps a YOUNG capture's columns on
            # real data instead of mostly pre-capture void — a no-op
            # once the capture outgrows the window
            lo, hi = self.ds.bnds[chan]
            end_time = float(hi / sr)
            st_time = max(float(lo / sr), end_time - cfg.stream_seconds)
        else:
            # a None side means that edge of the capture (utils.config)
            st_time, end_time = resolve_time_span(cfg.time_span,
                                                  self.ds.time_bnds)
        return time_to_sample(st_time, sr), time_to_sample(end_time, sr)

    def request_key(self, cfg: SpectrogramConfig):
        """Hashable identity of the EFFECTIVE request under the current
        bounds: the config snapshot plus the resolved channel and sample
        span. Two ticks with equal keys read the same samples through the
        same program with the same display knobs — their results are
        identical, so a delta-aware loop (runtime.processor) skips the
        read/transfer/recompute entirely. Bounds growth that does not
        move the resolved span (sub-sample growth, or an explicit
        time_span inside unchanged bounds) keeps the key equal; any
        change to the frame starts changes ``(s_samp, e_samp)`` and
        forces a recompute. The channel's interior data_version
        (io.reader) is part of the key: a backfill filling a gap
        BETWEEN unchanged bounds changes the samples without moving
        the resolved span, and without it the loop would re-emit the
        stale gap-masked columns forever. Call after ``bnds_update``."""
        chan, isub = self.channel_of(cfg)
        s_samp, e_samp = self._resolve_span(cfg, chan, self.ds.sr_dict[chan])
        return (cfg, chan, isub, s_samp, e_samp,
                self.ds.data_version.get(chan))

    def compute(self, config: Optional[SpectrogramConfig] = None,
                sample_span: Optional[Tuple[int, int]] = None,
                refresh_bounds: bool = True) -> StiResult:
        """Run one full STI request (one loop iteration of the reference's
        worker, drfProc.py:275-314).

        ``sample_span`` = absolute (first, last) frame-start samples —
        the bounds runtime.checkpoint's save_session persists. It bypasses
        the time->sample conversion so a resumed session reproduces the
        original frame starts EXACTLY (sample indices near 2^50 lose
        sub-sample precision through a float64 seconds round-trip, and a
        grown capture would otherwise widen a None time_span).

        ``refresh_bounds=False`` skips the per-channel HDF5 directory stat
        when the caller has already refreshed this tick (the processor
        loop refreshes before emitting stats, runtime.processor.run — the
        reference paid this stat twice per iteration too, drfProc.py:283
        via read_sti's adj_bnds path)."""
        import jax.numpy as jnp

        cfg = config or self.config
        self._iteration += 1
        chan, isub = self.channel_of(cfg)
        sr = self.ds.sr_dict[chan]
        ref = self.ds.ref_dict[chan]

        if refresh_bounds:
            self.ds.bnds_update()
        s_samp, e_samp = self._resolve_span(cfg, chan, sr, sample_span)

        n_st = self.ds.sti_frame_starts(s_samp, e_samp, cfg.nfft, cfg.nint,
                                        cfg.ntime)
        frame_len = cfg.nfft * cfg.nint
        chunks = None
        nbytes = (2 if isub is not None else 2 * len(self.ds.chan_2sub[chan])
                  ) * cfg.ntime * frame_len * 4
        if self.mesh is None and nbytes >= PREFETCH_MIN_BYTES:
            # large single-chip request: overlap the HDF5 read/assembly
            # with the host->device transfer (see
            # assemble_device_block_prefetch); the mesh tiers place
            # per-device shards, which device_put must do in one piece
            chunks, starts_rel, col_mask = assemble_device_block_prefetch(
                self.ds, chan, isub, n_st, frame_len)
            samples_pm = None
        else:
            samples_pm, starts_rel, col_mask = assemble_device_block(
                self.ds, chan, isub, n_st, frame_len
            )

        freqs = stft.shifted_freqs(cfg.nfft, sr)
        spec = None
        if cfg.display_tile:
            from pyspectrogram_tpu.display.tile import make_tile_spec

            # None (empty frequency window) falls back to the float path
            spec = make_tile_spec(freqs, cfg.freq_window_khz,
                                  cfg.color_range_db)

        if self.mesh is not None and self._use_bigfft(
                cfg, samples_pm.shape[0] // 2):
            out = self._compute_bigfft(cfg, ref, samples_pm, spec)
        elif self.mesh is not None:
            out = self._compute_sharded(cfg, ref, samples_pm, starts_rel,
                                        spec)
        else:
            fn = stft.make_sti_fn_pm(
                nfft=cfg.nfft, nint=cfg.nint, mode=cfg.mode,
                window=cfg.window, ref=ref, eps=cfg.eps,
                precision=cfg.precision,
                contiguous=True,  # assemble_device_block packs frames at
                                  # t*frame_len
                tile=spec,        # display epilogue fused into the program
            )
            dev = (jnp.concatenate(chunks, axis=1) if chunks is not None
                   else jnp.asarray(samples_pm))
            out = fn(dev, jnp.asarray(starts_rel))

        tile = plot_freqs = None
        if spec is not None:
            from pyspectrogram_tpu.display.tile import tile_freqs

            # every tier's tile-mode program emits "tile" INSTEAD of
            # "sxx_dbfs" (fused single-chip epilogue, sharded per-shard
            # quantize, bigfft k-matrix gather) — floats never left HBM
            tile = np.asarray(out["tile"])[: cfg.ntime]
            plot_freqs = tile_freqs(spec, freqs)
            sxx_dbfs = None           # floats intentionally stay on device
        else:
            # drop any time-axis padding the sharded path added
            sxx_tm = np.asarray(out["sxx_dbfs"])[: cfg.ntime]
            sxx_dbfs = stft.to_reference_layout(sxx_tm)
        sxx_med_dbfs = np.moveaxis(np.asarray(out["sxx_med_dbfs"]), -1, 0)
        times = samples_to_datetime64(n_st, sr)  # (ntime,) datetime64[us]
        return StiResult(
            iteration=self._iteration,
            times=times,
            freqs=freqs,
            sxx_dbfs=sxx_dbfs,
            sxx_med_dbfs=sxx_med_dbfs,
            sample_rate=sr,
            frame_starts=np.asarray(n_st),
            mask=col_mask,
            tile=tile,
            plot_freqs=plot_freqs,
        )

    def _use_bigfft(self, cfg: SpectrogramConfig, nsub: int) -> bool:
        """Meshed-request tier choice: column sharding (collective-free
        per shard) whenever the subchannel plane pairs divide over the
        chan axis; the dist-FFT tier only for transforms at/above
        ``bigfft_threshold`` whose plane pairs cannot be placed so."""
        from pyspectrogram_tpu.parallel.mesh import CHAN_AXIS

        chan = dict(self.mesh.shape).get(CHAN_AXIS, 1)
        return cfg.nfft >= self.bigfft_threshold and nsub % chan != 0

    def _compute_bigfft(self, cfg: SpectrogramConfig, ref: float,
                        samples_pm: np.ndarray, spec=None):
        """Distributed-FFT tier: the per-column transform itself shards
        over the mesh 'time' axis (SURVEY.md section 5, multi-device
        4-step FFT). With ``spec`` (display-tile mode) only a uint8 tile
        + the median PSD leave the device — readback stays O(display)
        exactly where nfft (>= 2^18) makes float readback largest."""
        import jax
        import jax.numpy as jnp

        from pyspectrogram_tpu.parallel.big_sti import (
            frames_to_x2,
            make_bigfft_sti_fn,
            to_freq_order,
        )
        from pyspectrogram_tpu.parallel.mesh import TIME_AXIS

        fn = make_bigfft_sti_fn(
            self.mesh, TIME_AXIS, nfft=cfg.nfft, nint=cfg.nint,
            mode=cfg.mode, window=cfg.window, ref=ref, eps=cfg.eps,
            precision=cfg.precision,
            # crop_key: programs key on the crop plan; colors ride as the
            # qparams operand so a re-clim reuses the compiled program
            tile=spec.crop_key() if spec is not None else None,
        )
        n1, n2 = fn.n1n2
        nseg = fn.nseg
        nsub = samples_pm.shape[0] // 2
        frame_len = cfg.nfft * cfg.nint
        # (nsub*2, ntime*frame_len) -> (ntime, nsub, 2, nseg*nfft) frames;
        # storage dtype is preserved (raw int16 planes stay int16 through
        # the transfer and widen per shard on device), so the one layout
        # copy here moves half the bytes for integer captures
        fp = samples_pm.reshape(nsub, 2, cfg.ntime, frame_len)
        frames_pm = np.ascontiguousarray(
            np.moveaxis(fp, 2, 0)[..., : nseg * cfg.nfft])
        x2 = jax.device_put(
            jnp.asarray(frames_to_x2(frames_pm, cfg.nfft, nseg, n1, n2)),
            fn.input_sharding)
        if spec is not None:
            out = fn(x2, spec.qparams)
            return {
                "tile": out["tile"],
                "sxx_med_dbfs": to_freq_order(out["sxx_med_dbfs"]),
            }
        out = fn(x2)
        return {
            "sxx_dbfs": to_freq_order(out["sxx_dbfs"]),
            "sxx_med_dbfs": to_freq_order(out["sxx_med_dbfs"]),
        }

    def _compute_sharded(self, cfg: SpectrogramConfig, ref: float,
                         samples_pm: np.ndarray, starts_rel: np.ndarray,
                         spec=None):
        """Multi-device request: shard columns over 'time', subchannels
        over 'chan' (see parallel.sharded for the layout).

        assemble_device_block always packs column t's frame at
        t*frame_len, so this path runs the CONTIGUOUS sharded tier: the
        sample buffer itself shards over the time axis (each device
        stores and receives only its own span — no replica per time-axis
        row).
        With a display ``spec``, the uint8 quantization is fused into the
        sharded program per shard (the color range is a runtime operand,
        so a re-clim re-runs the same compiled program)."""
        import jax
        import jax.numpy as jnp

        from pyspectrogram_tpu.parallel.mesh import (
            CHAN_AXIS, TIME_AXIS, pad_contiguous_block)
        from pyspectrogram_tpu.parallel.sharded import make_sharded_sti_fn

        chan = dict(self.mesh.shape).get(CHAN_AXIS, 1)
        nsub = samples_pm.shape[0] // 2
        if nsub % chan:
            # an indivisible split would scatter r/i plane pairs across
            # devices and each shard would pair a sub's imag plane with
            # the NEXT sub's real plane — well-shaped garbage, so refuse
            # loudly (the >= bigfft_threshold case reroutes to the
            # dist-FFT tier in _use_bigfft instead)
            raise ValueError(
                f"channel has {nsub} subchannel(s), which does not divide "
                f"over the mesh's {chan}-way '{CHAN_AXIS}' axis — use a "
                f"chan axis size that divides nsub (or 1)")
        frame_len = cfg.nfft * cfg.nint
        samples_pm, padded, nvalid = pad_contiguous_block(
            samples_pm, len(starts_rel), frame_len,
            self.mesh.shape[TIME_AXIS],
        )
        fn = make_sharded_sti_fn(
            self.mesh, nfft=cfg.nfft, nint=cfg.nint, ntime_valid=nvalid,
            mode=cfg.mode, window=cfg.window, ref=ref, eps=cfg.eps,
            contiguous=True,
            tile=spec.crop_key() if spec is not None else None,
        )
        shardings = fn.input_shardings()
        # samples_pm ships in its storage dtype: raw int16 planes cross
        # the host link at half the float bytes and widen per shard on
        # device; each device receives only its own column span
        args = [
            jax.device_put(jnp.asarray(samples_pm), shardings[0]),
            jax.device_put(jnp.asarray(padded), shardings[1]),
        ]
        if spec is not None:
            args.append(jax.device_put(jnp.asarray(spec.qparams),
                                       shardings[2]))
        return fn(*args)
