"""Shared refresh scheduler: merge same-shape tabs into one device launch.

The reference's concurrency story is up to 7 simultaneous tabs, each its
own worker thread driving its own compute (reference: drfview.py:177-178,
1101-1104) — on an accelerator that is N small dispatches per refresh
cycle where one batched dispatch would do (models.batch runs them as ONE
launch). This scheduler makes that tier reachable from the
client that actually has multiple tabs: ONE refresh thread serves every
registered written-mode processor, and each cycle it

1. refreshes bounds and re-emits effective stats per processor (loop
   parity with runtime.processor.run / reference drfProc.py:283-290);
2. delta-checks each processor's effective request (StiPipeline
   .request_key) and re-emits the cached result for unchanged ones —
   no read, no transfer, no device work (the delta-aware written loop);
3. groups the CHANGED requests by batch shape — nfft/nint/ntime/mode/
   window/precision/eps/subchannel count, plus the display crop plan in
   tile mode — and runs each group of >= 2 as ONE
   models.batch.BatchedStiPipeline launch; singletons and unbatchable
   requests (a meshed pipeline keeps its own sharded dispatch) fall back
   to their own pipeline exactly as a standalone processor would.

Processors opt in via ``SpectrogramProcessor(..., scheduler=...)``:
``start()`` then registers with the scheduler instead of spawning a
per-tab thread (streaming tabs always keep their own thread — the
incremental live engine's ring is stateful per tick, runtime.live).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from pyspectrogram_tpu.utils.errors import TerminateReason
from pyspectrogram_tpu.utils.log import get_logger, log_event

logger = get_logger("pstpu.scheduler")


class SharedRefreshScheduler:
    """One refresh loop for N written-mode processors.

    ``autostart=False`` skips the background thread so callers (tests,
    batch drivers) run deterministic cycles via :meth:`tick_once`.
    """

    def __init__(self, refresh_s: float = 0.1, autostart: bool = True):
        self.refresh_s = refresh_s
        self.autostart = autostart
        self._procs: List = []
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # drain support: tab_ids being served by the current cycle
        self._cv = threading.Condition()
        self._active: set = set()
        # observability (asserted by tests, quoted by docs)
        self.ticks = 0
        self.merged_launches = 0   # batched dispatches (>= 2 requests)
        self.merged_requests = 0   # requests served by merged launches
        self.solo_launches = 0     # single-request dispatches

    # ------------------------------------------------------------ registry
    def register(self, proc) -> None:
        with self._lock:
            if proc not in self._procs:
                self._procs.append(proc)
            if self.autostart and (self._thread is None
                                   or not self._thread.is_alive()):
                self._stop_evt.clear()
                self._thread = threading.Thread(target=self._run,
                                                daemon=True)
                self._thread.start()

    def unregister(self, proc) -> None:
        with self._lock:
            if proc in self._procs:
                self._procs.remove(proc)

    def stop(self, wait: bool = True) -> None:
        """Stop the refresh thread (used by client shutdown); registered
        processors are left as-is. ``wait=False`` only signals: an
        in-flight cycle may hold a compile, and a GUI
        main thread must not block on it (the thread is a daemon — it
        dies with the process either way)."""
        self._stop_evt.set()
        t = self._thread
        if wait and t is not None and t is not threading.current_thread():
            t.join()

    def drain(self, proc, timeout: Optional[float] = None) -> None:
        """Block until the current cycle (if any) is no longer serving
        ``proc`` — the scheduler-mode counterpart of joining a processor
        thread (clients wait out an in-flight compute before a save's
        full-resolution recompute)."""
        with self._cv:
            self._cv.wait_for(lambda: id(proc) not in self._active, timeout)

    # ---------------------------------------------------------------- loop
    def _run(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.tick_once()
            except Exception:
                # a cycle-level bug must not silently stop EVERY tab's
                # refreshes (per-tab failures already terminate just
                # that tab via _fail)
                logger.exception("refresh cycle failed; continuing")
            self._stop_evt.wait(self.refresh_s)

    def tick_once(self) -> None:
        """One refresh cycle over all registered processors (the loop
        body; public so tests and batch drivers run deterministic
        cycles)."""
        with self._lock:
            procs = list(self._procs)
        with self._cv:
            self._active = {id(p) for p in procs}
        try:
            self._tick(procs)
        finally:
            with self._cv:
                self._active = set()
                self._cv.notify_all()

    def _tick(self, procs) -> None:
        self.ticks += 1
        work = []  # (proc, cfg, key) whose effective request changed
        for p in procs:
            if not p.is_running or p._stop.is_set():
                self.unregister(p)
                continue
            try:
                cfg = p.config
                p.ds.bnds_update()
                p._emit_stats(cfg)
                key = p.pipeline.request_key(cfg)
            except Exception:
                self._fail(p)
                continue
            if key == p._last_key and p._last_result is not None:
                # unchanged request: re-emit the cached result (the
                # delta-aware written loop, runtime.processor.run)
                p.skipped_recomputes += 1
                self._deliver(p, p._last_result)
            else:
                work.append((p, cfg, key))
        groups: dict = {}
        order = []
        for item in work:
            gk = self._group_key(item[0], item[1])
            if gk not in groups:
                groups[gk] = []
                order.append(gk)
            groups[gk].append(item)
        for gk in order:
            members = groups[gk]
            if gk is None or len(members) == 1:
                for p, cfg, key in members:
                    self._solo(p, cfg, key)
            else:
                self._merged(members)

    # ------------------------------------------------------------ grouping
    @staticmethod
    def _group_key(p, cfg):
        """Hashable batch-compatibility key; None = never batch (meshed
        pipelines keep their own sharded dispatch). Two requests with
        equal keys fold into one BatchedStiPipeline launch: equal shape
        knobs and subchannel counts always, plus — in tile mode — an
        equal crop plan (sample rate + frequency window), since the
        merged program slices one static bin range (color ranges stay
        per-request runtime operands)."""
        if p.pipeline.mesh is not None:
            return None
        try:
            chan, isub = p.pipeline.channel_of(cfg)
            nsub = 1 if isub is not None else len(p.ds.chan_2sub[chan])
            sr = p.ds.sr_dict[chan]
        except Exception:
            return None
        return (cfg.nfft, cfg.nint, cfg.ntime, cfg.mode, cfg.window,
                cfg.precision, cfg.eps, nsub, cfg.display_tile,
                (cfg.freq_window_khz, sr) if cfg.display_tile else None)

    # ------------------------------------------------------------- compute
    def _solo(self, p, cfg, key) -> None:
        t0 = time.perf_counter()
        try:
            result = p.pipeline.compute(cfg, refresh_bounds=False)
        except Exception:
            self._fail(p)
            return
        p.latencies_s.append(time.perf_counter() - t0)
        p._last_key, p._last_result = key, result
        self.solo_launches += 1
        self._deliver(p, result)

    def _merged(self, members) -> None:
        from pyspectrogram_tpu.models.batch import BatchedStiPipeline

        base = members[0][1]  # shape knobs equal across the group
        t0 = time.perf_counter()
        try:
            bp = BatchedStiPipeline(
                [(p.ds, c.channel or None) for p, c, _ in members], base)
            results = bp.compute(
                # a member's None span must stay ITS full capture, not
                # inherit base's explicit span — (None, None) resolves to
                # that dataset's own bounds (utils.config.resolve_time_span)
                time_spans=[c.time_span if c.time_span is not None
                            else (None, None) for _, c, _ in members],
                color_ranges=[c.color_range_db for _, c, _ in members],
                refresh_bounds=False)
        except Exception:
            logger.exception("merged launch failed; falling back to solo "
                             "dispatches (%d requests)", len(members))
            for p, cfg, key in members:
                self._solo(p, cfg, key)
            return
        dt = time.perf_counter() - t0
        self.merged_launches += 1
        self.merged_requests += len(members)
        log_event(logger, "merged launch", requests=len(members),
                  seconds=dt)
        for (p, cfg, key), result in zip(members, results):
            p.latencies_s.append(dt)
            p._last_key, p._last_result = key, result
            self._deliver(p, result)

    # ------------------------------------------------------------ delivery
    def _deliver(self, p, result) -> None:
        if p._stop.is_set() and p._sched_delivered:
            # stop landed while this cycle was in flight and the consumer
            # already holds delivered state — same drop rule as
            # processor.run's stop-vs-inflight-frame handling
            return
        p._sched_i += 1
        try:
            p._emit_iterated(p._sched_i, result)
        except Exception:
            # a raising client callback terminates ITS tab (same as the
            # thread-mode loop's LOOP_EXCEPTION), never the shared loop
            self._fail(p)
            return
        p._sched_delivered = True
        if (p.max_iterations is not None
                and p._sched_i + 1 >= p.max_iterations):
            self._terminate(p, TerminateReason.OK)

    def _fail(self, p) -> None:
        import traceback

        # report the ORIGINAL error first: _terminate emits the client's
        # on_terminated callback, which may itself raise and would
        # otherwise swallow the traceback that got us here
        traceback.print_exc()
        p.is_running = False
        self._terminate(p, TerminateReason.LOOP_EXCEPTION)

    def _terminate(self, p, reason) -> None:
        """Terminate ONE tab without letting its on_terminated callback
        take the rest of the cycle down: in thread mode a double-raise
        (failing callback, then failing terminate emit) killed only that
        tab's own thread — here it would escape _tick and skip every
        remaining tab's refresh this cycle."""
        try:
            p._terminate(reason)  # unregisters via processor
        except Exception:
            logger.exception("terminate callback raised (tab %s)",
                             getattr(p, "tab_id", "?"))
            self.unregister(p)
