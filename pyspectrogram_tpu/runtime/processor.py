"""Worker-loop processor: the reference's ``DrfProcessor`` re-imagined.

Behavior parity with the reference worker (reference: drfProc.py:209-361):
* "written" mode re-reads the user-selected bounds every iteration;
  "streaming" mode chases the trailing ``stream_seconds`` window of a
  growing dataset (reference: drfProc.py:239-241, 291-296);
* bounds are refreshed each iteration (reference: drfProc.py:283);
* effective settings are re-emitted each iteration before compute
  (reference: drfProc.py:284-290);
* pacing sleeps between iterations (0.08 s streaming / 0.1 s written,
  reference: drfProc.py:316-321) — configurable here;
* terminate reason codes match (0 user stop, 1 missing path, 3 init
  timeout, 4 loop exception; reference: drfProc.py:245-246, 260-262,
  323-327, 347-352).

Differences by design (SURVEY.md section 5):
* settings updates swap an immutable ``SpectrogramConfig`` snapshot under a
  lock instead of mutating fields read concurrently by the loop — the
  reference has a (benign) data race here (drfview.py:933-940 vs
  drfProc.py:335-341);
* callbacks instead of Qt signals; a Qt client adapts them to slots;
* per-iteration latency/throughput counters are first-class (the reference
  has no instrumentation at all).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from pyspectrogram_tpu.io.reader import RFDataset
from pyspectrogram_tpu.models.sti import StiPipeline
from pyspectrogram_tpu.runtime.signals import (
    Iterated,
    ProcessorCallbacks,
    StatsUpdated,
    Terminated,
)
from pyspectrogram_tpu.utils.config import (
    SpectrogramConfig,
    resolve_time_span,
)
from pyspectrogram_tpu.utils.errors import TerminateReason
from pyspectrogram_tpu.utils.log import get_logger, log_event

logger = get_logger("pstpu.processor")


class SpectrogramProcessor:
    """One dataset's processing loop, running on a host thread.

    The device work inside each iteration is a single jitted program; the
    host thread is only orchestration + HDF5 IO.
    """

    def __init__(
        self,
        datasource: str,
        drfdir,
        tab_id: int,
        config: SpectrogramConfig,
        callbacks: Optional[ProcessorCallbacks] = None,
        written_sleep: float = 0.1,
        streaming_sleep: float = 0.08,
        max_iterations: Optional[int] = None,
        mesh=None,
        scheduler=None,
    ):
        """``mesh`` (a parallel.make_mesh Mesh) runs every iteration's
        compute multi-chip: written mode dispatches through
        StiPipeline(mesh=...) (column/chan sharding or the dist-FFT
        tier), streaming mode chan-shards the live ring
        (StreamingSti(mesh=...)).

        ``scheduler`` (a runtime.scheduler.SharedRefreshScheduler) makes
        written-mode ``start()`` register with the shared refresh loop
        instead of spawning a per-tab thread, so same-shape tabs merge
        into one batched device launch per cycle; streaming mode ignores
        it (the live engine's ring is stateful per tick)."""
        self.tab_id = tab_id
        self.callbacks = callbacks or ProcessorCallbacks()
        self.written_sleep = written_sleep
        self.streaming_sleep = streaming_sleep
        self.max_iterations = max_iterations
        self.reason: Optional[TerminateReason] = None
        self.is_running = False
        self._lock = threading.Lock()
        self._ready = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # bounded: a streaming session at the 0.08 s cadence would append
        # ~1 M floats/day unbounded; the percentile stats are over the
        # most recent window, which is what an operator wants anyway
        self.latencies_s = deque(maxlen=1 << 16)
        # delta-aware written loop: the last computed (request key,
        # result); ticks whose effective request is unchanged re-emit the
        # cached result instead of re-reading/recomputing (run()).
        self._last_key = None
        self._last_result = None
        self.skipped_recomputes = 0     # observability counter
        # shared-scheduler mode (runtime.scheduler): per-processor
        # iteration counter + delivered flag the scheduler maintains
        self._scheduler = scheduler
        self._sched_i = -1
        self._sched_delivered = False

        streaming = str(datasource).lower() == "streaming"
        self._config = config.replace(streaming=streaming)

        import pathlib

        if not pathlib.Path(drfdir).expanduser().exists():
            # reference: terminate(1) from __init__ (drfProc.py:245-246)
            self._terminate(TerminateReason.MISSING_PATH)
            return
        try:
            self.ds = RFDataset(drfdir)
            self.pipeline = StiPipeline(self.ds, self._config, mesh=mesh)
        except Exception as e:
            # the dir exists but opening it failed (corrupt capture,
            # unknown channel, ...) — report the REAL error, not the
            # reference's blanket missing-path code, or the GUI shows
            # "directory does not exist" for a directory that plainly does
            logger.exception("processor init failed (tab %d)", tab_id)
            self._terminate(TerminateReason.LOOP_EXCEPTION,
                            detail=f"Failed to open the dataset: {e}")
            return
        if streaming:
            # live mode is incremental: a ring + carry persist across
            # iterations and each tick reads only NEW samples — O(delta)
            # per refresh, not the reference's O(window) recompute
            # (reference: drfProc.py:239-241, 291-293; runtime.live)
            from pyspectrogram_tpu.runtime.live import _EngineSlot

            self._live = _EngineSlot(self.ds, mesh=self.pipeline.mesh)
        else:
            self._live = None
        self.chan_listing = list(self.ds.chan_2sub)
        self.sub_chan_list = list(self.ds.chan_entries)
        self.is_running = True
        self._ready.set()
        log_event(logger, "processor ready", tab_id=tab_id,
                  channels=self.chan_listing, streaming=streaming)

    # ------------------------------------------------------------- control
    @property
    def config(self) -> SpectrogramConfig:
        with self._lock:
            return self._config

    def start(self) -> "SpectrogramProcessor":
        """Spawn the worker thread (the reference runs on a QThreadPool,
        reference: drfview.py:1183) — or, with a shared ``scheduler`` in
        written mode, register with its refresh loop so same-shape tabs
        batch into one device launch per cycle (runtime.scheduler)."""
        if (self._scheduler is not None and self.is_running
                and getattr(self, "_live", None) is None):
            self._scheduler.register(self)
            return self
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()
        return self

    def run(self) -> None:
        """The loop body; callable directly (synchronously) for headless
        tests or via start()."""
        # init is synchronous (clients read chan_listing right after
        # construction), so _ready is always set by now — either by a
        # successful __init__ or by its _terminate. The reference's init
        # barrier + timeout (drfProc.py:260-262, code 3) has no role here.
        self._ready.wait()
        if self.reason is not None:
            return
        i = -1
        delivered = False
        try:
            while self.is_running and not self._stop.is_set():
                i += 1
                cfg = self.config
                self.ds.bnds_update()
                self._emit_stats(cfg)
                t0 = time.perf_counter()
                if self._live is not None:
                    result = self._live.tick(cfg)
                else:
                    # delta-aware written mode: when the EFFECTIVE request
                    # (config snapshot + resolved channel/sample span) is
                    # unchanged since the last computed result, re-emit
                    # that result instead of re-reading, re-shipping and
                    # recomputing identical arrays every 0.1 s tick — the
                    # reference recomputes unconditionally
                    # (drfProc.py:275-321), which leaves an idle tab
                    # permanently transfer-bound on slow transports. The
                    # compute skips its own bnds_update too: this loop
                    # just refreshed (one directory stat per tick).
                    key = self.pipeline.request_key(cfg)
                    if key == self._last_key and self._last_result is not None:
                        result = self._last_result
                        self.skipped_recomputes += 1
                    else:
                        result = self.pipeline.compute(
                            cfg, refresh_bounds=False)
                        self._last_key, self._last_result = key, result
                self.latencies_s.append(time.perf_counter() - t0)
                if self._stop.is_set() and delivered:
                    # Stop arrived while compute was in flight (a new
                    # shape's compile can hold this iteration) —
                    # Terminated has already been emitted, so delivering
                    # this stale Iterated would overwrite state the
                    # consumer captured at stop time and race any save
                    # the client started after the stop. Exception: when
                    # NOTHING was delivered yet, the consumer has no
                    # captured state to protect and dropping the frame
                    # would throw away the run's only result — emit it.
                    return
                if result is None:
                    # capture still shorter than one STI column — keep
                    # chasing bounds until data appears
                    if (self.max_iterations is not None
                            and i + 1 >= self.max_iterations):
                        self._terminate(TerminateReason.OK)
                        return
                    self._stop.wait(self.streaming_sleep)
                    continue
                self._emit_iterated(i, result)
                delivered = True
                if self._stop.is_set():
                    return
                if self.max_iterations is not None and i + 1 >= self.max_iterations:
                    self._terminate(TerminateReason.OK)
                    return
                self._stop.wait(
                    self.streaming_sleep if cfg.streaming else self.written_sleep
                )
        except Exception:
            import traceback

            # report the ORIGINAL loop error BEFORE the terminate emit —
            # a raising on_terminated callback would otherwise swallow
            # the root cause entirely (runtime.scheduler._fail orders it
            # the same way)
            traceback.print_exc()
            self.is_running = False
            try:
                self._terminate(TerminateReason.LOOP_EXCEPTION)
            except Exception:
                traceback.print_exc()

    def update_settings(
        self,
        nfft: Optional[int] = None,
        nint: Optional[int] = None,
        ntime: Optional[int] = None,
        bnd_beg: Optional[float] = None,
        bnd_end: Optional[float] = None,
        **extra,
    ) -> None:
        """Settings slot (reference: drfProc.py:329-345): swap an immutable
        config snapshot and echo effective stats."""
        if getattr(self, "ds", None) is None:
            # __init__ terminated before the dataset opened (MISSING_PATH)
            # — the loop will never read a config, so fail soft like the
            # reason-code paths instead of leaking an AttributeError
            return
        with self._lock:
            kw = dict(extra)
            if nfft is not None:
                kw["nfft"] = int(nfft)
            if nint is not None:
                kw["nint"] = int(nint)
            if ntime is not None:
                kw["ntime"] = int(ntime)
            if bnd_beg is not None or bnd_end is not None:
                cur = resolve_time_span(self._config.time_span,
                                        self.ds.time_bnds)
                kw["time_span"] = (
                    cur[0] if bnd_beg is None else float(bnd_beg),
                    cur[1] if bnd_end is None else float(bnd_end),
                )
            self._config = self._config.replace(**kw)
            cfg = self._config
        self._emit_stats(cfg)

    def select_channel(self, chan_entry: str) -> None:
        with self._lock:
            self._config = self._config.replace(channel=chan_entry)

    def abort(self) -> None:
        """User stop (reference: drfProc.py:347-352)."""
        self._terminate(TerminateReason.OK)

    # --------------------------------------------------- live checkpointing
    @property
    def has_live_state(self) -> bool:
        """True when a streaming run has a ring to checkpoint (clients use
        this to enable their save-stream-state affordance)."""
        return (getattr(self, "_live", None) is not None
                and self._live.engine is not None)

    def save_live_state(self, path):
        """Persist streaming mode's mid-stream state (ring + carry + read
        cursor) so a later run resumes with runtime.live's
        LiveStreamEngine.resume — no recompute of already-seen samples.
        Call after the loop has stopped (join() first when threaded)."""
        if not self.has_live_state:  # also covers a failed-init processor
            raise ValueError(
                "no live engine to checkpoint (requires streaming mode "
                "and at least one completed iteration)")
        return self._live.engine.save(path)

    def preload_live_state(self, path) -> None:
        """Seed streaming mode from a save_live_state checkpoint BEFORE
        run(): the first tick continues the saved stream instead of
        re-reading a cold trailing window."""
        from pyspectrogram_tpu.runtime.live import LiveStreamEngine

        if getattr(self, "_live", None) is None:
            raise ValueError("preload_live_state requires streaming mode")
        self._live.engine = LiveStreamEngine.resume(
            self.ds, self.config, path, mesh=self.pipeline.mesh)

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
        elif self._scheduler is not None:
            # scheduler mode has no per-tab thread: "join" = wait out the
            # refresh cycle currently serving this processor (if any)
            self._scheduler.drain(self, timeout)

    # ------------------------------------------------------------ internal
    def _emit_iterated(self, i: int, result) -> None:
        """One Iterated payload from an StiResult (shared by run() and the
        shared-scheduler delivery path, runtime.scheduler)."""
        self.callbacks.emit_iterated(Iterated(
            i=i,
            tab_id=self.tab_id,
            times=result.times,
            freqs=result.freqs,
            sxx_dbfs=result.sxx_dbfs,
            sxx_med_dbfs=result.sxx_med_dbfs,
            tile=result.tile,
            plot_freqs=result.plot_freqs,
            mask=result.mask,
        ))

    def _emit_stats(self, cfg: SpectrogramConfig) -> None:
        chan, _ = self.pipeline.channel_of(cfg)
        self.callbacks.emit_stats(StatsUpdated(
            tab_id=self.tab_id,
            sample_rate=self.ds.sr_dict[chan],
            nfft=cfg.nfft,
            nint=cfg.nint,
            ntime=cfg.ntime,
            time_bounds=resolve_time_span(cfg.time_span, self.ds.time_bnds),
        ))

    def _terminate(self, reason: TerminateReason,
                   detail: Optional[str] = None) -> None:
        self.reason = reason
        self.is_running = False
        self._stop.set()
        if self._scheduler is not None:
            self._scheduler.unregister(self)
        # wake any run() blocked in _ready.wait(): a failed __init__ must
        # not stall synchronous callers
        self._ready.set()
        log_event(logger, "processor terminated", tab_id=self.tab_id,
                  reason=int(reason), detail=detail or reason.describe(),
                  latency=self.latency_stats())
        self.callbacks.emit_terminated(
            Terminated(self.tab_id, reason, detail))

    # --------------------------------------------------------- observability
    def latency_stats(self) -> dict:
        """p50/p99 iteration latency — the instrumentation the reference
        lacks entirely (SURVEY.md section 5)."""
        if not self.latencies_s:
            return {"n": 0}
        a = np.asarray(self.latencies_s)
        return {
            "n": len(a),
            "p50_s": float(np.percentile(a, 50)),
            "p99_s": float(np.percentile(a, 99)),
            "mean_s": float(a.mean()),
        }
