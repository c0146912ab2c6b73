"""Incremental live-streaming engine: O(delta) work per refresh.

The reference's streaming mode re-reads and recomputes the ENTIRE trailing
30 s window on every 0.08 s refresh (reference: drfProc.py:239-241,
291-293) — O(window) HDF5 IO, host->device transfer and FFT per tick.
Here the live path is incremental: the engine keeps a
:class:`~pyspectrogram_tpu.models.streaming.StreamingSti` ring + carry
across ticks and, per tick, reads ONLY the samples written since the last
pushed column, pushes them, and serves the display from the on-device
ring:

* every new sample is read exactly once (``samples_read`` counts them);
* the refresh view is a stride-decimated trailing-window snapshot that
  leaves the device as a uint8 tile (<= ntime rows), so per-tick readback
  is O(display), not O(window);
* the median PSD is computed on device over the window's columns.

The engine is rebuilt only when a SHAPE knob changes
(:meth:`signature`); color-range and freq-window changes ride as runtime
operands / crop-plan cache keys of the snapshot programs.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Optional

import numpy as np

from pyspectrogram_tpu.io.reader import RFDataset
from pyspectrogram_tpu.io.time_util import samples_to_datetime64
from pyspectrogram_tpu.models.sti import StiResult, _assemblable
from pyspectrogram_tpu.models.streaming import StreamingSti
from pyspectrogram_tpu.ops import stft
from pyspectrogram_tpu.utils.config import SpectrogramConfig

#: per-push block target (samples): big enough to amortize dispatch
#: (a push is one dispatch), small enough that new data surfaces
#: within a refresh tick (~0.07 s of samples at 1 MS/s)
TARGET_BLOCK_SAMPLES = 1 << 16
#: device-memory cap for the column ring (float32 power columns)
RING_BYTE_BUDGET = 512 << 20


def _signature(cfg: SpectrogramConfig):
    """The knobs whose change forces a ring rebuild (static shapes /
    numerics of the compiled push — eps is baked into every dB/tile
    program, so it is a numerics knob too). Color range, freq window,
    ntime and display_tile are display-edge knobs and do NOT re-init
    the ring. The hop entry is canonicalized to its effective value
    (None means contiguous = nfft*nint), so hop=None and an explicit
    contiguous hop describe the same ring."""
    return (cfg.nfft, cfg.nint, cfg.mode, cfg.window, cfg.precision,
            cfg.channel, float(cfg.stream_seconds), float(cfg.eps),
            int(cfg.hop or cfg.nfft * cfg.nint))


class LiveStreamEngine:
    """One channel's incremental trailing-window stream over a (possibly
    growing) dataset.

    >>> eng = LiveStreamEngine(ds, cfg)
    >>> res = eng.tick(cfg)    # push new samples, return an StiResult
    """

    def __init__(self, ds: RFDataset, cfg: SpectrogramConfig, mesh=None,
                 target_block_samples: int = TARGET_BLOCK_SAMPLES,
                 cols_per_block: Optional[int] = None,
                 init_device_state: bool = True):
        """``cols_per_block`` pins the push-block geometry explicitly
        (resume() passes the checkpointed value so the rebuilt ring has
        the same shape); by default it is derived from
        ``target_block_samples`` and the data available right now.
        ``init_device_state=False`` skips allocating the zeroed device
        ring (resume() installs a restored one instead — avoids holding
        two full rings in HBM during a large-window resume)."""
        self.ds = ds
        self.mesh = mesh
        self.sig = _signature(cfg)
        chan, isub = ds._split_entry(cfg.channel or ds.channels[0])
        self.chan, self.isub = chan, isub
        self.sr: Fraction = ds.sr_dict[chan]
        self.ref = ds.ref_dict[chan]
        self.nsub = 1 if isub is not None else len(ds.chan_2sub[chan])
        frame_len = cfg.nfft * cfg.nint
        # column spacing: contiguous by default; cfg.hop < frame_len
        # overlaps columns (overlap-save — the carry holds the trailing
        # frame_len - hop samples between pushes, README.md:16)
        self.hop = int(cfg.hop or frame_len)
        self.carry_len = frame_len - self.hop
        self._iteration = -1
        self.samples_read = 0                   # O(delta) observability

        # trailing-window geometry: how many hop-spaced columns cover
        # stream_seconds (reference streamtime, drfProc.py:241)
        w = int(-(-(cfg.stream_seconds * self.sr) // self.hop))  # ceil
        cap = max(1, RING_BYTE_BUDGET // (self.nsub * cfg.nfft * 4))
        self.window_cols = max(1, min(w, cap))

        # block size: ~TARGET_BLOCK_SAMPLES, whole columns, and no larger
        # than the initially-available data so short/young captures still
        # surface columns block by block
        lo, hi = ds.bnds[chan]
        if cols_per_block is not None:
            k = int(cols_per_block)
        else:
            # frame-aware: a block of k columns needs carry_len + k*hop
            # samples, so k must subtract the carry — or an overlap-hop
            # capture that stops growing just short of a carry-blind
            # block would never push (and with total_cols == 0, tick()
            # would return None forever despite complete columns)
            avail_cols = max(1, (hi - lo + 1 - self.carry_len) // self.hop)
            k = max(1, min(target_block_samples // self.hop,
                           avail_cols, self.window_cols))
        self.cols_per_block = k
        self.block_len = k * self.hop
        # round the ring up to whole blocks: stores stay wrap-free
        ring_len = -(-self.window_cols // k) * k

        # tail-view machinery: complete columns that do not yet fill a
        # whole push block still surface in the display (see _tail_view)
        self._tail_pending = 0
        self._tail_fns: dict = {}
        self._tail_cache_key = None
        self._tail_cache = None
        self.tail_samples_read = 0              # peek-read observability
        self._cfg = cfg                         # numerics knobs for _tail_fn

        self.sti = StreamingSti(
            nfft=cfg.nfft, nint=cfg.nint, nsub=self.nsub,
            block_len=self.block_len, hop=self.hop, ring_len=ring_len,
            mode=cfg.mode, window=cfg.window, ref=self.ref, eps=cfg.eps,
            precision=cfg.precision, mesh=mesh,
        )
        self.state = self.sti.init_state() if init_device_state else None
        # host-side shadows of device state: the engine knows exactly how
        # many columns it pushed, so no tick ever reads the total back
        # from the device (a scalar readback syncs the stream)
        self.total_cols = 0
        # per-column validity, same rotating storage as the device ring:
        # a column computed over zero-filled gap samples is flagged, like
        # the batch path's mask (SURVEY.md section 5 failure detection;
        # the reference crashed on gaps)
        self.col_mask = np.ones(ring_len, bool)
        # gap shadow of the device carry (frame_len - hop samples): with
        # overlapping hops a column's validity spans carry + block
        self._carry_mask = np.ones(self.carry_len, bool)
        # anchor at the current trailing window (cold start reads at most
        # one window, never the whole capture). Column j's frame covers
        # [start_sample + j*hop, + frame_len): the window's last frame
        # ends at the data tail when the anchor backs off by the extra
        # carry_len (0 for contiguous hops).
        self.start_sample = max(
            lo, hi + 1 - (self.window_cols * self.hop + self.carry_len))
        self.next_sample = self.start_sample + self.carry_len
        if init_device_state and self.carry_len:
            self._seed_carry()

    def _seed_carry(self) -> None:
        """Overlapping hops only: pre-fill the device carry with the
        frame_len - hop samples before the first block slice, so column 0
        covers [start_sample, start_sample + frame_len) with real data
        (reads before the capture start zero-fill and flag the gap mask,
        like any gap; resume() installs a checkpointed carry instead)."""
        import jax
        import jax.numpy as jnp

        from pyspectrogram_tpu.native import ingest as native_ingest

        raw, mask = self.ds.reader.read_vector_raw(
            self.start_sample, self.carry_len, self.chan, return_mask=True)
        if self.isub is not None:
            raw = raw[:, self.isub : self.isub + 1]
        pm = native_ingest.assemble_plane_major(
            _assemblable(raw), np.asarray([0], np.int64), self.carry_len)
        carry = jnp.asarray(np.asarray(pm, np.float32))
        carry_sh = self.sti._shardings()[0]
        if carry_sh is not None:
            carry = jax.device_put(carry, carry_sh)
        self.state = dataclasses.replace(self.state, carry=carry)
        self._carry_mask = np.asarray(mask, bool)
        self.samples_read += self.carry_len

    def _col_valid(self, m: np.ndarray, n: int) -> np.ndarray:
        """Validity of ``n`` hop-spaced columns whose frames slide over
        the sample-mask ``m`` (carry mask + block/tail mask): column t is
        valid iff m[t*hop : t*hop + frame_len] has no gap. O(len(m)) via
        a gap-count prefix sum (hop == frame_len degenerates to the
        per-block reshape this replaces)."""
        frame_len = self.hop + self.carry_len
        bad = np.concatenate([[0], np.cumsum(~np.asarray(m, bool))])
        t = np.arange(n) * self.hop
        return bad[t + frame_len] - bad[t] == 0

    # ----------------------------------------------------------- checkpoint
    def save(self, path):
        """Checkpoint the live session mid-stream: the device ring + carry
        plus the host read cursor, so :meth:`resume` continues reading at
        the exact next sample with no recompute. Call between ticks (the
        CLI/GUI call it after the loop stops) — not concurrently with one.

        The reference's data model makes any *request* reproducible
        (absolute sample indexing, reference: drfProc.py:132-167); this
        makes the live *stream* itself resumable, which the reference's
        recompute-the-window loop cannot be.
        """
        import json

        from pyspectrogram_tpu.runtime import checkpoint

        meta = {
            "kind": "live_stream",
            # json round-trip now so resume() compares like with like
            # (tuples inside the signature become lists either way)
            "signature": json.loads(json.dumps(self.sig)),
            "next_sample": int(self.next_sample),
            "start_sample": int(self.start_sample),
            "total_cols": int(self.total_cols),
            "samples_read": int(self.samples_read),
            "cols_per_block": int(self.cols_per_block),
        }
        return checkpoint.save_stream_state(
            path, self.state, meta,
            extra_arrays={"col_mask": self.col_mask,
                          "carry_mask": self._carry_mask})

    @classmethod
    def resume(cls, ds: RFDataset, cfg: SpectrogramConfig, path,
               mesh=None) -> "LiveStreamEngine":
        """Rebuild an engine from a :meth:`save` checkpoint and continue
        the stream: the next tick reads from the saved cursor (O(delta)
        from where the old session stopped; the backlog-skip logic
        handles a producer that ran far ahead meanwhile). With ``mesh``
        the restored ring/carry are re-placed under the chan-sharded
        layout, so a sharded live session resumes sharded."""
        import json

        from pyspectrogram_tpu.runtime import checkpoint

        state, meta = checkpoint.load_stream_state(path)
        if meta.get("kind") != "live_stream":
            raise ValueError(
                f"{path} is not a live-stream checkpoint "
                f"(kind={meta.get('kind')!r})")
        eng = cls(ds, cfg, mesh=mesh,
                  cols_per_block=int(meta["cols_per_block"]),
                  init_device_state=False)
        saved_sig = meta["signature"]
        if len(saved_sig) == len(eng.sig) - 1:
            # pre-hop checkpoints (<= round 4) were always contiguous:
            # their effective hop is nfft*nint, so normalize instead of
            # refusing every existing checkpoint
            saved_sig = list(saved_sig) + [
                int(saved_sig[0]) * int(saved_sig[1])]
        if json.loads(json.dumps(eng.sig)) != saved_sig:
            raise ValueError(
                f"checkpoint was written with different shape knobs "
                f"({meta['signature']} vs {list(eng.sig)}); pass the "
                f"config the stream was started with")
        # full-shape checks: the signature can't see dataset-derived
        # geometry (nsub), so a same-config checkpoint from a
        # different-subchannel dataset must still be refused loudly
        want_ring = (eng.sti.ring_len, eng.nsub, cfg.nfft)
        want_carry = (eng.nsub * 2, eng.sti.frame_len - eng.sti.hop)
        if (tuple(state.ring.shape) != want_ring
                or tuple(state.carry.shape) != want_carry):
            raise ValueError(
                f"stream-state geometry mismatch: checkpoint ring/carry "
                f"{tuple(state.ring.shape)}/{tuple(state.carry.shape)} vs "
                f"this dataset's {want_ring}/{want_carry}")
        # the device counter folds before int32 wrap (fold_total), so an
        # unbounded host cursor compares through the fold
        if (int(np.asarray(state.total_cols))
                != eng.sti.fold_total(int(meta["total_cols"]))):
            raise ValueError(
                "torn checkpoint: device column count "
                f"({int(np.asarray(state.total_cols))}) disagrees with "
                f"the host cursor ({meta['total_cols']}) — the state was "
                "saved mid-tick; re-save from a quiesced session")
        if mesh is not None:
            import jax

            from pyspectrogram_tpu.models.streaming import StreamState

            carry_sh, ring_sh, _ = eng.sti._shardings()
            state = StreamState(
                carry=jax.device_put(np.asarray(state.carry), carry_sh),
                ring=jax.device_put(np.asarray(state.ring), ring_sh),
                total_cols=state.total_cols,
            )
        eng.state = state
        eng.total_cols = int(meta["total_cols"])
        eng.start_sample = int(meta["start_sample"])
        eng.next_sample = int(meta["next_sample"])
        eng.samples_read = int(meta["samples_read"])
        mask = meta.get("arrays", {}).get("col_mask")
        if mask is not None:
            eng.col_mask = np.asarray(mask).astype(bool)
        cmask = meta.get("arrays", {}).get("carry_mask")
        if cmask is not None and len(cmask) == eng.carry_len:
            eng._carry_mask = np.asarray(cmask).astype(bool)
        return eng

    # ---------------------------------------------------------------- ingest
    def _push_new(self) -> int:
        """Read + push every complete new block; returns blocks pushed."""
        import jax.numpy as jnp

        from pyspectrogram_tpu.native import ingest as native_ingest

        lo, hi = self.ds.bnds[self.chan]
        behind = hi + 1 - self.next_sample
        max_backlog = self.window_cols * self.hop
        if behind > max_backlog + self.block_len:
            # the producer outran us by more than a whole window: data we
            # haven't read would be evicted from the ring before anyone
            # saw it. Restart the ring at the new trailing window instead
            # of reading stale samples (keeps reads O(window) worst-case).
            self.state = self.sti.init_state()
            self.total_cols = 0
            self.col_mask[:] = True
            self.start_sample = hi + 1 - max_backlog - self.carry_len
            self.next_sample = self.start_sample + self.carry_len
            self._carry_mask = np.ones(self.carry_len, bool)
            if self.carry_len:
                self._seed_carry()
        n_blocks = 0
        block_sh = self.sti.block_sharding()
        while hi + 1 - self.next_sample >= self.block_len:
            raw, mask = self.ds.reader.read_vector_raw(
                self.next_sample, self.block_len, self.chan,
                return_mask=True)
            rows = (self.total_cols
                    + np.arange(self.cols_per_block)) % self.sti.ring_len
            m = np.concatenate([self._carry_mask, mask])
            self.col_mask[rows] = self._col_valid(m, self.cols_per_block)
            if self.carry_len:
                self._carry_mask = m[len(m) - self.carry_len:]
            self.samples_read += self.block_len
            if self.isub is not None:
                raw = raw[:, self.isub : self.isub + 1]
            pm = native_ingest.assemble_plane_major(
                _assemblable(raw), np.asarray([0], np.int64), self.block_len)
            blk = jnp.asarray(pm)
            if block_sh is not None:
                import jax

                blk = jax.device_put(blk, block_sh)
            self.state, _ = self.sti.push(self.state, blk, return_db=False)
            self.total_cols += self.cols_per_block
            self.next_sample += self.block_len
            n_blocks += 1
        # complete columns beyond the cursor that do not yet fill a whole
        # block (0..cols_per_block-1); the tail view surfaces them. A
        # column is complete when its whole frame exists: the next
        # unpushed column starts carry_len before the cursor.
        avail = hi + 1 - (self.next_sample - self.carry_len)
        frame_len = self.hop + self.carry_len
        self._tail_pending = int(
            max(0, (avail - frame_len) // self.hop + 1)
            if avail >= frame_len else 0)
        return n_blocks

    # ------------------------------------------------------------- tail view
    def _tail_fn(self, n: int, spec):
        """Cached device program computing ``n`` contiguous columns'
        display rows (uint8 tile with ``spec``, float dBFS without) via
        the canonical single-chip program (ops.stft.make_sti_fn_pm, the
        ring push's XLA body). Keyed on the pow2 column
        count and the tile crop plan; color range rides as the runtime
        qparams operand, exactly like the snapshot programs."""
        key = (n, None if spec is None else spec.crop_key())
        fn = self._tail_fns.get(key)
        if fn is None:
            cfg = self._cfg
            fn = stft.make_sti_fn_pm(
                nfft=cfg.nfft, nint=cfg.nint, mode=cfg.mode,
                window=cfg.window, ref=self.ref, eps=cfg.eps,
                # overlapping hops: frames start every hop < frame_len
                # samples, so the contiguous fast path doesn't apply and
                # the factory's gather path slices them from the buffer
                contiguous=self.carry_len == 0,
                precision=cfg.precision, tile=spec,
            )
            if len(self._tail_fns) >= 16:
                self._tail_fns.pop(next(iter(self._tail_fns)))
            self._tail_fns[key] = fn
        return fn

    def _tail_view(self, spec, stride: int):
        """Display rows for the pending tail: complete columns past the
        read cursor that do not yet fill a whole push block.

        Without this, a capture that stops growing permanently hides its
        last ``cols_per_block - 1`` columns — the block-granular ring
        never ingests them, while the reference's recompute-the-window
        loop showed all available data. The tail is computed as a
        side view (the cursor does NOT advance): the same samples are
        re-read into the ring once their block completes, so ring pushes
        stay block-aligned and checkpoints stay exact (a resume re-reads
        the tail from the saved cursor). Cost is bounded O(block) per
        tick and cached — a fully stopped writer computes it once.

        Returns (rows, cols, mask) continuing tick()'s stride grid
        (absolute column j displayed iff (j - total + 1) % stride == 0),
        or (None, None, None) when nothing lands on the grid. The median
        stays ring-only: tail columns join it when their block completes
        (<= cols_per_block-1 of up to ring_len columns).
        """
        import jax.numpy as jnp

        from pyspectrogram_tpu.native import ingest as native_ingest

        pending = self._tail_pending
        grid = np.arange(stride - 1, pending, stride, dtype=np.int64)
        if len(grid) == 0:
            return None, None, None
        qp = (None if spec is None
              else tuple(np.asarray(spec.qparams, np.float32).tolist()))
        key = (self.next_sample, pending,
               None if spec is None else spec.crop_key(), qp)
        if key == self._tail_cache_key:
            rows, colmask = self._tail_cache
        else:
            # the next unpushed column starts carry_len before the read
            # cursor (its frame reuses the carry's samples); the last
            # pending column's frame ends frame_len past its start
            span = (pending - 1) * self.hop + self.hop + self.carry_len
            raw, mask = self.ds.reader.read_vector_raw(
                self.next_sample - self.carry_len, span, self.chan,
                return_mask=True)
            self.tail_samples_read += span
            if self.isub is not None:
                raw = raw[:, self.isub : self.isub + 1]
            pm = native_ingest.assemble_plane_major(
                _assemblable(raw), np.asarray([0], np.int64), span)
            # pow2 ladder: O(log cols_per_block) compiled programs as the
            # tail grows, not one per pending count
            n = 1 << (pending - 1).bit_length()
            if n > pending:
                pad = (n - pending) * self.hop
                pm = np.concatenate(
                    [pm, np.zeros((pm.shape[0], pad), pm.dtype)], axis=1)
            out = self._tail_fn(n, spec)(
                jnp.asarray(pm),
                jnp.arange(n, dtype=jnp.int32) * self.hop,
                *(() if spec is None else (spec.qparams,)))
            # both outputs are row-major like the snapshot view:
            # (n, nsub, plot_n) uint8 tile / (n, nsub, nfft) float dBFS
            rows = np.asarray(out["tile" if spec is not None
                                  else "sxx_dbfs"])[:pending]
            colmask = self._col_valid(mask, pending)
            self._tail_cache_key = key
            self._tail_cache = (rows, colmask)
        cols = self.total_cols + grid
        return rows[grid], cols, colmask[grid]

    # --------------------------------------------------------------- display
    def tick(self, cfg: SpectrogramConfig) -> Optional[StiResult]:
        """One refresh: ingest the delta, then build the display payload
        from the ring (no recompute of already-pushed columns). Returns
        None while the capture is still shorter than one column."""
        self._push_new()
        total = self.total_cols            # host-tracked: no readback
        if total == 0:
            return None
        self._iteration += 1

        W = self.window_cols
        n_target = max(1, min(cfg.ntime, W))
        stride = -(-W // n_target)                       # ceil
        n_disp = -(-W // stride)
        # The median span over a still-filling window rides StreamingSti's
        # floor-pow2 ladder (StreamingSti._span) so a growing capture
        # compiles O(log W) median programs, not one per tick.
        cols = self.sti.strided_cols(self.state, n_disp, stride,
                                     total_cols=total)
        keep = cols >= 0

        freqs = stft.shifted_freqs(cfg.nfft, self.sr)
        spec = None
        if cfg.display_tile:
            from pyspectrogram_tpu.display.tile import make_tile_spec

            spec = make_tile_spec(freqs, cfg.freq_window_khz,
                                  cfg.color_range_db)
        tile = plot_freqs = sxx_dbfs = None
        # one fused device program for view + median: one dispatch per
        # refresh and one fewer compile at cold start. On a mesh the same
        # program runs shard_map'd over chan, so the meshed tick is one
        # dispatch too (models.streaming.refresh_view).
        view, med = self.sti.refresh_view(
            self.state, n_disp, stride, spec=spec, n_med=W,
            total_cols=total)
        view = view[keep]
        kept_cols = cols[keep]
        mask = self.col_mask[kept_cols % self.sti.ring_len]
        if self._tail_pending:
            # complete columns past the read cursor that do not yet fill
            # a push block: surface them EVERY tick, so under continuous
            # writing the newest complete column appears in the same tick
            # it completes (the reference's recompute loop showed every
            # complete column; hiding up to cols_per_block-1 of them
            # while blocks flow was round 4's one display gap). Cost is
            # bounded O(block) per tick — the tail read is < one block —
            # and the (next_sample, pending) cache key makes a stalled
            # writer's tail free after its first tick.
            t_rows, t_cols, t_mask = self._tail_view(spec, stride)
            if t_rows is not None:
                view = np.concatenate([view, t_rows], axis=0)
                kept_cols = np.concatenate([kept_cols, t_cols])
                mask = np.concatenate([mask, t_mask])
        if spec is not None:
            from pyspectrogram_tpu.display.tile import tile_freqs

            tile, plot_freqs = view, tile_freqs(spec, freqs)
        else:
            sxx_dbfs = stft.to_reference_layout(view)
        starts = self.start_sample + kept_cols * self.hop
        return StiResult(
            iteration=self._iteration,
            times=samples_to_datetime64(starts, self.sr),
            freqs=freqs,
            sxx_dbfs=sxx_dbfs,
            sxx_med_dbfs=np.moveaxis(med, -1, 0),
            sample_rate=self.sr,
            frame_starts=np.asarray(starts),
            mask=mask,
            tile=tile,
            plot_freqs=plot_freqs,
        )


@dataclasses.dataclass
class _EngineSlot:
    """Processor-side holder: rebuilds the engine when the config's shape
    signature changes (the settings-change case — shape knobs are static,
    so a new ring is the correct semantics; reference's streaming loop
    likewise starts fresh windows, drfProc.py:291-293)."""

    ds: RFDataset
    mesh: object = None
    engine: Optional[LiveStreamEngine] = None

    def tick(self, cfg: SpectrogramConfig) -> Optional[StiResult]:
        sig = _signature(cfg)
        if self.engine is None or self.engine.sig != sig:
            self.engine = LiveStreamEngine(self.ds, cfg, mesh=self.mesh)
        return self.engine.tick(cfg)
