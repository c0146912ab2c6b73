"""Tracing and latency instrumentation.

The reference has no profiling hooks at all — its only pacing is fixed
sleeps (reference: drfProc.py:316-321; SURVEY.md section 5 'tracing —
ABSENT'). Here stage annotation and latency tracking are first-class: the
benchmark metric itself is p50 block -> STI-column latency (BASELINE.md),
so the pipeline publishes it.
"""

from __future__ import annotations

import contextlib
import subprocess
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np


class StageTimer:
    """Thread-safe per-stage wall-clock histogram.

    Stages nest via the context manager; when JAX is importable the block
    is also wrapped in a ``jax.profiler.TraceAnnotation`` so device traces
    (``jax.profiler.trace``) carry the same stage names.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._samples: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        ann = None
        try:
            import jax.profiler

            ann = jax.profiler.TraceAnnotation(name)
            ann.__enter__()
        except Exception:
            ann = None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if ann is not None:
                ann.__exit__(None, None, None)
            with self._lock:
                self._samples[name].append(dt)

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self._samples[name].append(seconds)

    def stats(self, name: Optional[str] = None) -> dict:
        with self._lock:
            names = [name] if name else list(self._samples)
            out = {}
            for n in names:
                a = np.asarray(self._samples.get(n, []))
                if len(a) == 0:
                    out[n] = {"n": 0}
                    continue
                out[n] = {
                    "n": int(len(a)),
                    "p50_s": float(np.percentile(a, 50)),
                    "p99_s": float(np.percentile(a, 99)),
                    "mean_s": float(a.mean()),
                    "total_s": float(a.sum()),
                }
            return out[name] if name else out

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()


#: process-wide default timer used by the pipeline stages
GLOBAL_TIMER = StageTimer()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a JAX device profile into ``log_dir`` (TensorBoard format)."""
    import jax.profiler

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_calls(call: Callable, repeats: int) -> Tuple[float, np.ndarray]:
    """(cold seconds, warm seconds per call): the host clock around
    ``jax.block_until_ready`` of each call's result — JAX returns before
    the device finishes, so timing without it measures the enqueue. The
    first (cold) call includes compilation."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(call())
    cold = time.perf_counter() - t0
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(call())
        ts.append(time.perf_counter() - t0)
    return cold, np.asarray(ts)


def card_line() -> str:
    """The GPU's name and power limit as ``nvidia-smi`` reports them — a
    card below its power limit runs slower, so every timing carries it."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
