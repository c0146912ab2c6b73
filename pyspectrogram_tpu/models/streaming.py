"""Streaming STI: blockwise overlap-save STFT + on-device rolling ring.

The reference's "streaming" mode recomputes the entire trailing-30 s window
from scratch every iteration (reference: drfProc.py:239-241, 291-293) — an
O(window) recompute per refresh. Here streaming is incremental: fixed-size
sample blocks are pushed; each push computes only the new STI columns
(overlap-save: a (frame_len - hop)-sample carry rides between blocks,
README wishlist streaming mode, README.md:16) and appends them to a
rolling on-device ring of dB columns. The ring never leaves HBM except
when a client snapshots it (or a quantized uint8 view of it).

Shapes are fully static: ``block_len`` must be a multiple of ``hop``, so
every push yields exactly ``block_len // hop`` columns and the carry stays
(frame_len - hop) samples.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from pyspectrogram_tpu.ops.stft import (
    median_over_time,
    to_dbfs,
)
from pyspectrogram_tpu.ops.windows import WindowSpec, get_window


@dataclasses.dataclass
class StreamState:
    """On-device streaming state (a pytree)."""

    carry: jax.Array        # (nsub*2, frame_len - hop) trailing samples,
                            # plane-major like all device sample buffers
    ring: jax.Array         # (ring_len, nsub, nfft) LINEAR power columns,
                            # oldest first (dB happens at the display edge so
                            # medians stay exact: median-of-dB != dB-of-median
                            # for even column counts)
    total_cols: jax.Array   # int32 scalar: columns produced since start,
                            # folded back by a ring_len multiple before it
                            # could wrap at 2^31 (stays congruent to the
                            # true count mod ring_len and >= ring_len once
                            # full; see StreamingSti.fold_total)


jax.tree_util.register_dataclass(
    StreamState, data_fields=["carry", "ring", "total_cols"], meta_fields=[]
)


def donate_argnums() -> tuple:
    """Donate the push's state argument unless the backend is the CPU,
    which ignores donation (tests would only see a warning)."""
    return () if jax.default_backend() == "cpu" else (0,)


class StreamingSti:
    """Incremental STI over an unbounded sample stream.

    >>> s = StreamingSti(nfft=1024, nint=2, nsub=1, block_len=8192)
    >>> state = s.init_state()
    >>> state, cols_db = s.push(state, pm_block)       # jitted, on device
    >>> sti_db, n_valid = s.snapshot(state)            # host view of ring

    Blocks are plane-major (nsub*2, block_len) float32 (row 2s = subchannel
    s real plane, row 2s+1 imag), like every device sample buffer in this
    framework.
    """

    #: device column-counter fold threshold. int32 would wrap after 2^31
    #: pushed columns (~25 days of continuous 1 kHz column rate), silently
    #: desyncing storage rows from the host shadow; instead the counter
    #: folds back by a ring_len multiple once it crosses this, preserving
    #: every mod-ring_len row computation and min(total, ring_len).
    #: Tests shrink it to exercise the fold in a few pushes.
    _FOLD_CAP = 1 << 30

    def __init__(
        self,
        *,
        nfft: int,
        nint: int = 1,
        nsub: int = 1,
        block_len: int,
        hop: Optional[int] = None,
        ring_len: int = 1024,
        mode: str = "welch",
        window: WindowSpec = ("kaiser", 1.7),
        ref: float = 1.0,
        eps: float = 1e-15,
        precision: str = "exact",
        mesh=None,
    ):
        """``precision`` is accepted like the batch path's (utils.config) and
        kept in checkpoint signatures; the stream's FFT is exact float32.

        ``mesh`` (a parallel.make_mesh Mesh) shards the stream over the
        ``chan`` axis: subchannel plane pairs, the carry and the ring all
        live sharded, each device pushes its own subchannels — the push
        stays collective-free, and the time median needs no gather either
        because every device holds ALL columns of its subchannel slice
        (SURVEY.md section 5 scaling axes; the trailing-window mode of
        reference: drfProc.py:291-293 scales with the pod)."""
        self.nfft, self.nint, self.nsub = nfft, nint, nsub
        self.precision = precision
        self.mesh = mesh
        if mesh is not None:
            from pyspectrogram_tpu.parallel.mesh import CHAN_AXIS

            ndev_c = mesh.shape[CHAN_AXIS]
            if nsub % ndev_c:
                raise ValueError(
                    f"nsub {nsub} must divide by the chan axis ({ndev_c})")
        self.frame_len = nfft * nint
        self.hop = self.frame_len if hop is None else hop
        if self.hop <= 0 or self.hop > self.frame_len:
            raise ValueError("hop must be in (0, nfft*nint]")
        if block_len % self.hop != 0:
            raise ValueError("block_len must be a multiple of hop")
        self.block_len = block_len
        self.cols_per_block = block_len // self.hop
        if self.cols_per_block > ring_len:
            raise ValueError("ring_len must hold at least one block of columns")
        self.ring_len = ring_len
        self.mode = mode
        self.eps = eps
        self._fold_at = ring_len * max(2, self._FOLD_CAP // ring_len)

        get_window(window, nfft)  # validate the window spec eagerly
        self._window = window
        self._ref = float(ref)
        self._push, self._push_nodb = self._build_push()
        # cache the jitted dB view once — a fresh jit wrapper per snapshot
        # would retrace/recompile every call
        self._snapshot_db = jax.jit(functools.partial(to_dbfs, eps=self.eps))
        # per-instance jit caches (a module-level lru_cache on a method
        # would key on self and pin the instance + its compiled programs
        # for the life of the process)
        self._tile_fns: dict = {}
        self._median_fns: dict = {}
        ring_len = self.ring_len

        @jax.jit
        def _deroll(ring, total_cols):
            # storage position of the NEXT write == oldest data; rolling
            # it to index -n... mapping storage[i] -> i - pos puts zeros
            # first and data oldest->newest at the tail, matching the
            # non-rotating layout exactly
            pos = (total_cols % ring_len).astype(jnp.int32)
            return jnp.roll(ring, -pos, axis=0)

        self._deroll = _deroll

    def init_state(self) -> StreamState:
        state = StreamState(
            carry=jnp.zeros((self.nsub * 2, self.frame_len - self.hop),
                            jnp.float32),
            ring=jnp.zeros((self.ring_len, self.nsub, self.nfft),
                           jnp.float32),
            total_cols=jnp.int32(0),
        )
        if self.mesh is not None:
            carry_sh, ring_sh, block_sh = self._shardings()
            state = StreamState(
                carry=jax.device_put(state.carry, carry_sh),
                ring=jax.device_put(state.ring, ring_sh),
                total_cols=state.total_cols,
            )
        return state

    def _shardings(self):
        """(carry, ring, block) NamedShardings of the chan-sharded stream
        (None without a mesh)."""
        if self.mesh is None:
            return None, None, None
        from jax.sharding import NamedSharding, PartitionSpec as P

        from pyspectrogram_tpu.parallel.mesh import CHAN_AXIS

        return (
            NamedSharding(self.mesh, P(CHAN_AXIS, None)),
            NamedSharding(self.mesh, P(None, CHAN_AXIS, None)),
            NamedSharding(self.mesh, P(CHAN_AXIS, None)),
        )

    def block_sharding(self):
        """Placement for incoming blocks on the mesh (None single-device);
        pushing host blocks works without it, but pre-placing avoids a
        broadcast-then-reshard."""
        return self._shardings()[2]

    def _build_push(self):
        nfft, nint, nsub = self.nfft, self.nint, self.nsub
        frame_len, hop, k = self.frame_len, self.hop, self.cols_per_block
        mode, eps = self.mode, self.eps
        # circular storage: a push writes ONLY its k new columns at a
        # rotating offset instead of rewriting the entire ring with a
        # shifted concatenate — at 4096-pt/ring 256 that replaces an
        # 8 MB HBM rewrite per push with a 128 KB write. Read paths
        # (snapshot/median) de-rotate on demand, which is rare. The
        # rotation is a pure function of total_cols, so storage layout is
        # deterministic and checkpoints convert without knowing the
        # streamer (runtime.checkpoint ring_layout="rotated").
        self._rotating = True
        ring_len = self.ring_len
        # when k divides ring_len a write never wraps, so it is a single
        # dynamic_update_slice; otherwise scatter by modular row index
        wrap_free = ring_len % k == 0

        def store(ring, cols, total_cols):
            pos = (total_cols % ring_len).astype(jnp.int32)
            if wrap_free:
                return jax.lax.dynamic_update_slice(ring, cols, (pos, 0, 0))
            idx = (pos + jnp.arange(k, dtype=jnp.int32)) % ring_len
            return ring.at[idx].set(cols)

        # one per-shard body for every hop: the shared gather+Welch XLA
        # body (parallel.sharded, ops.stft.make_xla_psd); hop < frame_len
        # (overlap-save) gathers the overlapping frames at element offsets
        from pyspectrogram_tpu.parallel.sharded import make_local_sti

        xla_psd = make_local_sti(
            nfft=nfft, nint=nint, mode=mode, window=self._window,
            ref=self._ref)
        starts_k = np.arange(k, dtype=np.int32) * hop

        fold_at = self._fold_at

        def core(carry, ring, total_cols, block):
            """Per-shard push body: everything is local to a device's
            subchannel slice (collective-free). Returns LINEAR new
            columns; the dB view is applied (or skipped) by the jitted
            wrappers below."""
            buf = jnp.concatenate([carry, block.astype(jnp.float32)],
                                  axis=1)               # (nsub2_l, carry+blk)
            cols = xla_psd(buf, starts_k)
            new_carry = buf[:, buf.shape[1] - (frame_len - hop):]
            total_new = total_cols + k
            # fold before the int32 counter can wrap (see _FOLD_CAP):
            # subtracting a ring_len multiple keeps every storage-row
            # computation (all mod ring_len) and min(total, ring_len)
            total_new = jnp.where(total_new >= fold_at,
                                  total_new - (fold_at - ring_len),
                                  total_new)
            return (new_carry, store(ring, cols, total_cols),
                    total_new, cols)

        if self.mesh is not None:
            from jax import shard_map
            from jax.sharding import PartitionSpec as P

            from pyspectrogram_tpu.parallel.mesh import CHAN_AXIS

            core = shard_map(
                core,
                mesh=self.mesh,
                in_specs=(P(CHAN_AXIS, None), P(None, CHAN_AXIS, None),
                          P(), P(CHAN_AXIS, None)),
                out_specs=(P(CHAN_AXIS, None), P(None, CHAN_AXIS, None),
                           P(), P(None, CHAN_AXIS, None)),
                check_vma=False,
            )

        # donate the state so XLA aliases the ring in place: without it
        # every push copies the WHOLE ring to a fresh output buffer — at
        # 2^20 with nsub 2 and a 256-column ring that is 2 GiB read and
        # written per push. The API contract is already move-semantics
        # (`state, cols = s.push(state, block)`); donation just enforces
        # what callers do.
        donate = donate_argnums()

        @functools.partial(jax.jit, donate_argnums=donate)
        def push_db(state: StreamState, block: jax.Array):
            carry, ring, total, cols = core(
                state.carry, state.ring, state.total_cols, block)
            return (StreamState(carry=carry, ring=ring, total_cols=total),
                    to_dbfs(cols, eps))

        @functools.partial(jax.jit, donate_argnums=donate)
        def push_nodb(state: StreamState, block: jax.Array):
            # the hot ingest path: both production callers (runtime.live,
            # the CLI stream loop) discard the dB columns, so this
            # variant drops the log10 pass AND its (k, nsub, nfft)
            # float32 output buffer (8 MB per push at 2^20/nsub=2)
            carry, ring, total, _ = core(
                state.carry, state.ring, state.total_cols, block)
            return StreamState(carry=carry, ring=ring, total_cols=total)

        return push_db, push_nodb

    def _ordered_ring(self, state: StreamState):
        """Ring in canonical layout (oldest-first in the LAST n slots,
        like the non-rotating storage), de-rotated on device."""
        if not self._rotating:
            return state.ring
        return self._deroll(state.ring, state.total_cols)

    def push(self, state: StreamState, block, return_db: bool = True
             ) -> Tuple[StreamState, Optional[jax.Array]]:
        """Consume one plane-major (nsub*2, block_len) block; returns
        (new_state, new dB columns (cols_per_block, nsub, nfft)).

        ``return_db=False`` (the hot ingest path) skips the dB pass and
        its per-push output buffer entirely and returns (new_state,
        None) — use it when only the ring/snapshot views are consumed.

        Move semantics: on an accelerator the input ``state``'s device
        buffers are DONATED (the ring updates in place; keeping a
        reference to the pre-push state and reading it later raises).
        Snapshot/save a state BEFORE pushing from it if you need the old
        contents."""
        if return_db:
            return self._push(state, block)
        return self._push_nodb(state, block), None

    def fold_total(self, total: int) -> int:
        """Device-side value of the column counter after ``total`` true
        columns: equal below the fold threshold, then offset into the
        fold orbit [ring_len, fold_at). Host bookkeeping that compares
        an unbounded true count against the device scalar (e.g. the
        checkpoint torn-state check) must compare through this."""
        if total < self._fold_at:
            return int(total)
        period = self._fold_at - self.ring_len
        return int(self.ring_len + (total - self.ring_len) % period)

    # ------------------------------------------------------------- queries
    def valid_cols(self, state: StreamState) -> int:
        return int(min(int(state.total_cols), self.ring_len))

    def snapshot(self, state: StreamState) -> Tuple[np.ndarray, int]:
        """Host copy of the ring in dBFS (oldest column first; unfilled
        slots read as the eps floor) + valid count."""
        db = self._snapshot_db(self._ordered_ring(state))
        return np.asarray(db), self.valid_cols(state)

    def snapshot_quantized(self, state: StreamState, spec) -> Tuple[np.ndarray, int]:
        """Host copy of the ring as a uint8 display tile + valid count.

        ``spec`` is a display.TileSpec; de-rotation, frequency crop,
        decimation, dB and 256-level quantization all run in ONE jitted
        device program, so the readback is (ring_len, nsub, plot_n) uint8
        — 4-16x fewer bytes than the float snapshot() on every refresh
        (the north-star display path, BASELINE.md; reference:
        drfview.py:1006-1023 + drfview.py:1057). Rows are oldest-first
        like snapshot(); unfilled slots quantize the eps floor (level 0
        for any sane color range)."""
        q = self._tile_fn(spec)(state.ring, state.total_cols, spec.qparams)
        return np.asarray(q), self.valid_cols(state)

    def _tile_fn(self, spec):
        # keyed on the crop plan only: the color range is a runtime
        # operand, so re-clims reuse the compiled program
        crop = spec.crop_key()
        fn = self._tile_fns.get(crop)
        if fn is None:
            from pyspectrogram_tpu.display.tile import quantize_tile_linear

            ring_len, eps = self.ring_len, self.eps

            @jax.jit
            def f(ring, total_cols, qparams):
                pos = (total_cols % ring_len).astype(jnp.int32)
                ordered = jnp.roll(ring, -pos, axis=0)
                return quantize_tile_linear(ordered, crop, eps, qparams)

            fn = self._put(self._tile_fns, crop, f, 16)
        return fn

    def _span(self, n_valid: int, window: int, ladder: bool) -> int:
        """Median span while the window is still FILLING. Device median
        programs are compiled per static column count, and on a young
        capture the fill count grows every push — compiling for the exact
        count would build a fresh program per tick and thrash the bounded
        program caches. Ride
        a geometric ladder instead: the newest floor-pow2 columns until
        the window fills, then exactly ``window`` forever — at most
        log2(window)+1 programs per ring lifetime."""
        if n_valid >= window:
            return window
        return (1 << (n_valid.bit_length() - 1)) if ladder else n_valid

    def median_psd(self, state: StreamState, n_cols: Optional[int] = None,
                   total_cols: Optional[int] = None,
                   span_ladder: bool = True) -> np.ndarray:
        """Median dBFS PSD over the valid ring columns (median taken in
        linear power, like the batch path; reference: drfProc.py:401).

        ``n_cols`` restricts the median to the NEWEST n_cols columns (the
        live trailing-window semantics, reference: drfProc.py:291-293);
        default is every valid column. ``total_cols`` lets a caller that
        tracks the push count host-side (runtime.live) skip the device
        scalar readback valid_cols() costs. With an explicit ``n_cols`` window that the fill has
        not reached yet, the span rides a floor-pow2 ladder
        (see :meth:`_span`) so repeated calls on a growing stream compile
        O(log window) programs, not one per push; ``span_ladder=False``
        forces the exact fill count. Without ``n_cols`` the median is
        EXACT over every valid column (the analytic semantic — prefer
        passing a window when polling a growing stream)."""
        n_valid = (min(int(total_cols), self.ring_len)
                   if total_cols is not None else self.valid_cols(state))
        if n_valid == 0:
            raise ValueError("no columns pushed yet")
        if n_cols is None:
            n = n_valid
        else:
            n = self._span(n_valid, min(self.ring_len, int(n_cols)),
                           span_ladder)
        med = self._median_fn(n)(self._ordered_ring(state))
        return np.asarray(med)

    # ------------------------------------------------- trailing-window view
    def strided_cols(self, state: StreamState, n_disp: int,
                     stride: int, total_cols=None) -> np.ndarray:
        """(n_disp,) absolute column indices snapshot_strided selects,
        oldest first; entries < 0 are unfilled rows (quantize/read as the
        eps floor) — trim them on the host. Pass ``total_cols`` when the
        caller host-tracks the push count (live engine) so this never
        forces a device scalar readback; on
        streams beyond ~2^30 columns it is also REQUIRED for correct
        absolute indices (the device counter folds, fold_total)."""
        newest = (int(total_cols) if total_cols is not None
                  else int(state.total_cols)) - 1
        return newest - stride * np.arange(n_disp - 1, -1, -1,
                                           dtype=np.int64)

    def _check_span(self, n_disp: int, stride: int) -> None:
        if stride < 1 or n_disp < 1:
            raise ValueError("n_disp and stride must be >= 1")
        if stride * (n_disp - 1) >= self.ring_len:
            raise ValueError(
                f"window span {stride * (n_disp - 1) + 1} cols exceeds the "
                f"ring ({self.ring_len}) — selected rows would alias")

    def _trailing_view_body(self, n_disp: int, stride: int, crop):
        """Traced body shared by _strided_fn and refresh_view: gather the
        stride-decimated trailing window out of rotated storage and format
        it for display (dBFS floats; a uint8 tile with a crop plan)."""
        ring_len, eps = self.ring_len, self.eps
        if crop is not None:
            from pyspectrogram_tpu.display.tile import quantize_tile_linear

        def body(ring, total_cols, qparams):
            # column c lives at storage row c % ring_len (the push
            # writes at total_cols % ring_len), so the trailing-window
            # gather needs no de-roll; negative columns wrap onto rows
            # at/above total_cols, which are provably unwritten while
            # any selected column is negative (span < ring_len)
            cols = (total_cols - 1) - stride * jnp.arange(
                n_disp - 1, -1, -1, dtype=jnp.int32)
            sel = jnp.take(ring, jnp.mod(cols, ring_len), axis=0)
            if crop is None:
                return to_dbfs(sel, eps)
            return quantize_tile_linear(sel, crop, eps, qparams)

        return body

    def snapshot_strided(self, state: StreamState, n_disp: int, stride: int,
                         spec=None) -> np.ndarray:
        """Trailing-window view, time-decimated ON DEVICE before readback.

        Selects every ``stride``-th column ending at the newest one —
        n_disp rows spanning the last ``stride*(n_disp-1)+1`` columns —
        straight out of the rotated ring storage (an n_disp-row gather, no
        full-ring de-roll). With ``spec`` (a display.TileSpec) the rows
        are also freq-cropped + quantized, so a live refresh reads back a
        (n_disp, nsub, plot_n) uint8 tile no matter how many columns the
        ring holds; without it, (n_disp, nsub, nfft) float dBFS.

        This is the on-device form of the reference's sparse trailing
        window (its linspace of ntime frame starts over the last 30 s,
        reference: drfProc.py:159, drfProc.py:291-293): the ring computes
        EVERY column, the display edge strides over them. Rows whose
        column index is negative (see strided_cols) read unwritten slots.
        """
        self._check_span(n_disp, stride)
        crop = None if spec is None else spec.crop_key()
        fn = self._strided_fn(n_disp, stride, crop)
        q = spec.qparams if spec is not None else np.zeros(2, np.float32)
        return np.asarray(fn(state.ring, state.total_cols, q))

    def refresh_view(self, state: StreamState, n_disp: int, stride: int,
                     spec=None, n_med: Optional[int] = None,
                     total_cols: Optional[int] = None,
                     span_ladder: bool = True):
        """One-program live refresh: the stride-decimated trailing-window
        view AND the windowed median PSD from a single jitted call: the
        tick makes one dispatch and cold start compiles one program fewer
        (2 instead of 3).

        Returns (view, med_db): ``view`` as in :meth:`snapshot_strided`
        (uint8 tile with ``spec``, float dBFS without); ``med_db``
        (nsub, nfft) over the newest ``n_med`` valid columns (riding the
        floor-pow2 fill ladder while the window fills, :meth:`_span`;
        ``span_ladder=False`` forces the exact count).

        With a ``mesh`` the same body runs inside a shard_map over the
        ``chan`` axis — every step (trailing gather, quantize/dB, the
        windowed median) is local to a device's subchannel slice, so the
        meshed live tick is ONE dispatch too, with zero collectives
        (round 4 fell back to two dispatches + a separate median
        program on a mesh)."""
        self._check_span(n_disp, stride)
        total = (int(total_cols) if total_cols is not None
                 else int(state.total_cols))
        n_valid = min(total, self.ring_len)
        if n_valid == 0:
            raise ValueError("no columns pushed yet")
        window = (min(self.ring_len, int(n_med)) if n_med is not None
                  else self.ring_len)
        n = self._span(n_valid, window, span_ladder)
        crop = None if spec is None else spec.crop_key()
        key = ("refresh", n_disp, stride, crop, n)
        fn = self._tile_fns.get(key)
        if fn is None:
            ring_len, eps = self.ring_len, self.eps
            view_body = self._trailing_view_body(n_disp, stride, crop)

            def f_local(ring, total_cols, qparams):
                view = view_body(ring, total_cols, qparams)
                # newest n columns, straight from rotated storage (no
                # de-roll: row of column c is c % ring_len)
                mcols = total_cols - n + jnp.arange(n, dtype=jnp.int32)
                msel = jnp.take(ring, jnp.mod(mcols, ring_len), axis=0)
                return view, to_dbfs(median_over_time(msel), eps)

            if self.mesh is None:
                f = jax.jit(f_local)
            else:
                # per-shard fused view+median, same pattern as
                # _median_fn's meshed branch: every step is local to a
                # device's chan slice
                from jax import shard_map
                from jax.sharding import PartitionSpec as P

                from pyspectrogram_tpu.parallel.mesh import CHAN_AXIS

                f = jax.jit(shard_map(
                    f_local, mesh=self.mesh,
                    in_specs=(P(None, CHAN_AXIS, None), P(), P()),
                    out_specs=(P(None, CHAN_AXIS, None), P(CHAN_AXIS, None)),
                    check_vma=False))
            fn = self._put(self._tile_fns, key, f, 16)
        q = spec.qparams if spec is not None else np.zeros(2, np.float32)
        view, med = fn(state.ring, state.total_cols, q)
        return np.asarray(view), np.asarray(med)

    def _strided_fn(self, n_disp: int, stride: int, crop):
        key = ("strided", n_disp, stride, crop)
        fn = self._tile_fns.get(key)
        if fn is None:
            fn = self._put(self._tile_fns, key,
                           jax.jit(self._trailing_view_body(n_disp, stride,
                                                            crop)), 16)
        return fn

    def _median_fn(self, n: int):
        fn = self._median_fns.get(n)
        if fn is None:
            start, eps = self.ring_len - n, self.eps

            def local(ring):
                return to_dbfs(median_over_time(ring[start:]), eps)

            if self.mesh is None:
                f = jax.jit(local)
            else:
                # per-shard median inside a shard_map: each device runs
                # the selection on its OWN chan slice with no collective
                # — same pattern as parallel.sharded
                from jax import shard_map
                from jax.sharding import PartitionSpec as P

                from pyspectrogram_tpu.parallel.mesh import CHAN_AXIS

                f = jax.jit(shard_map(
                    local, mesh=self.mesh,
                    in_specs=P(None, CHAN_AXIS, None),
                    out_specs=P(CHAN_AXIS, None), check_vma=False))
            fn = self._put(self._median_fns, n, f, 32)
        return fn

    @staticmethod
    def _put(cache: dict, key, fn, cap: int):
        # bounded like the lru_caches these dicts replaced: a long-lived
        # streamer seeing many fill counts / crop plans must not
        # accumulate compiled programs without end
        if len(cache) >= cap:
            cache.pop(next(iter(cache)))
        cache[key] = fn
        return fn
