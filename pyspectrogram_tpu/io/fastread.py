"""Parallel, GIL-free bulk sample reads from Digital RF captures.

The reference's IO hot path is ntime sequential ``read_vector`` calls per
STI refresh through libdigital_rf (reference: drfProc.py:161-166) — and
a per-file HDF5 read loop (``io.h5lite`` or h5py) serializes every byte
through Python, so reader threads cannot scale it.

This module reads the bulk data without a library in the loop: the HDF5
metadata is parsed ONCE per file (``io.h5lite``) to probe the
``rf_data`` extent map (one byte
offset for a contiguous dataset; the per-chunk byte offsets for an
uncompressed full-row-width chunked dataset, which is what this package's
writer produces), the row count/dtype, and the ``rf_data_index`` block
table (a few KB). After that, sample rows are plain byte ranges, read
directly into the destination buffer with ``os.preadv`` from a thread
pool: no HDF5 library in the loop, no GIL, no intermediate copies. Files
the probe cannot map (compressed/filtered, subchannel-split chunks,
non-native byte order) fail it and the caller falls back to the
per-file path, so results are always identical.

Storage dtypes and memory dtypes are byte-identical here (complex64 IS
the {r: f4, i: f4} compound; int16 compounds stay structured), so reading
raw bytes into the memory-dtype array is exact.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from pyspectrogram_tpu.io import drf_format as fmt

#: below this many bytes a parallel read is pure overhead
MIN_PARALLEL_BYTES = 2 * 1024 * 1024

#: split large per-file segments into jobs of this size so a few big files
#: still spread across the pool
JOB_BYTES = 8 * 1024 * 1024

#: probed-file cache cap: a multi-day live session at 1 s file cadence
#: otherwise accumulates one _FileMap (index + chunk offsets) per file
#: forever; eviction is FIFO (oldest files first — exactly the ones a
#: trailing-window reader stops touching) and only costs a re-probe
MAPS_CAP = 8192


@dataclasses.dataclass(frozen=True)
class _FileMap:
    """Everything needed to read a data file without an HDF5 library.

    The extent map is (chunk_rows, chunk_offsets): a contiguous dataset is
    one implicit chunk of all rows; a full-row-width uncompressed chunked
    dataset has chunk k covering rows [k*chunk_rows, (k+1)*chunk_rows) at
    byte offset chunk_offsets[k] (HDF5 allocates chunks full-size, so the
    mapping holds for the final partial chunk too).
    """

    nrows: int
    row_bytes: int
    chunk_rows: int
    chunk_offsets: np.ndarray   # (nchunks,) int64 byte offsets, -1 = hole
    index: np.ndarray           # (nblocks, 2) int64 (global_sample, row)
    mtime_ns: int


class FastSpanReader:
    """Reads dense sample spans with pooled preadv after one metadata probe.

    One instance per reader object; thread-safe. ``read_into`` returns
    False (without touching ``out``) when any overlapping file cannot be
    mapped, so callers can fall back to the per-file path.
    """

    def __init__(self, workers: Optional[int] = None):
        self.workers = workers or min(16, (os.cpu_count() or 4))
        self._maps: Dict[Path, _FileMap] = {}
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None

    # ------------------------------------------------------------ probing
    def _probe(self, path: Path) -> Optional[_FileMap]:
        try:
            st = path.stat()
        except OSError:
            return None
        with self._lock:
            fm = self._maps.get(path)
            if fm is not None and fm.mtime_ns == st.st_mtime_ns:
                return fm
        from pyspectrogram_tpu.io import h5lite

        try:
            with h5lite.File(path) as f:
                ds = f["rf_data"]
                # filtered (compressed, shuffled) or subchannel-split
                # chunks and big-endian fields raise Unsupported here:
                # raw preadv would return garbage marked valid
                chunk_rows, chunk_offsets = ds.extents()
                fm = _FileMap(
                    nrows=int(ds.shape[0]),
                    row_bytes=ds.row_bytes,
                    chunk_rows=chunk_rows,
                    chunk_offsets=chunk_offsets,
                    index=f["rf_data_index"][...].astype(np.int64),
                    mtime_ns=st.st_mtime_ns,
                )
        except Exception:
            return None
        with self._lock:
            while len(self._maps) >= MAPS_CAP:
                self._maps.pop(next(iter(self._maps)))  # FIFO eviction
            self._maps[path] = fm
        return fm

    # ------------------------------------------------------------- reads
    def read_into(
        self,
        props: fmt.ChannelProperties,
        channel_dir: Path,
        start: int,
        n: int,
        out: np.ndarray,
        mask: Optional[np.ndarray] = None,
    ) -> bool:
        """Fill ``out`` (n, nsub) from [start, start+n), zeroing gap rows.

        ``out`` may be uninitialized (np.empty): data rows are written by
        preadv and only the gap complement is zeroed — for a gapless
        multi-GB read that skips a full page-faulting memset. Returns
        False if any overlapping file cannot be fast-mapped; the caller
        must then use the per-file path. ``mask`` (n,) bool is set True where
        data exists.

        On a False return ``out``/``mask`` may have been PARTIALLY
        written (rows read or zeroed before the failing file was probed)
        — callers must treat their contents as undefined and fully
        rebuild via the fallback path, as read_vector_raw does.
        """
        if not hasattr(os, "preadv"):  # not on Windows/older macOS
            return False
        end = start + n
        covered = mask if mask is not None else np.zeros(n, bool)
        # the gap-zeroing below trusts False entries only: a caller-reused
        # mask with stale True rows would leave np.empty garbage marked
        # valid, so establish the all-False precondition here
        covered[:] = False
        row_bytes = out.dtype.itemsize * (out.shape[1] if out.ndim > 1 else 1)
        jobs: List[Tuple[Path, int, int, int]] = []  # path, byte_off, dest_row, nrows
        for _, path in fmt.files_overlapping(props, channel_dir, start, end):
            fm = self._probe(path)
            if fm is None:
                return False
            if fm.row_bytes != row_bytes:
                return False
            idx = fm.index
            for k in range(len(idx)):
                g0, r0 = int(idx[k, 0]), int(idx[k, 1])
                r1 = int(idx[k + 1, 1]) if k + 1 < len(idx) else fm.nrows
                g1 = g0 + (r1 - r0)
                lo, hi = max(start, g0), min(end, g1)
                if lo >= hi:
                    continue
                # split the row range at chunk-extent boundaries
                row = r0 + (lo - g0)
                dest = lo - start
                left = hi - lo
                while left > 0:
                    ci = row // fm.chunk_rows
                    in_chunk = row - ci * fm.chunk_rows
                    take = min(left, fm.chunk_rows - in_chunk)
                    base = int(fm.chunk_offsets[ci])
                    if base < 0:
                        return False  # indexed rows in an unallocated chunk
                    off = base + in_chunk * row_bytes
                    # HDF5 usually allocates consecutive chunks back to
                    # back; merging byte-adjacent pieces keeps one preadv
                    # per contiguous extent instead of one per chunk
                    if jobs and jobs[-1][0] == path and (
                        jobs[-1][1] + jobs[-1][3] * row_bytes == off
                        and jobs[-1][2] + jobs[-1][3] == dest
                    ):
                        p_, o_, d_, n_ = jobs[-1]
                        jobs[-1] = (p_, o_, d_, n_ + take)
                    else:
                        jobs.append((path, off, dest, take))
                    row += take
                    dest += take
                    left -= take
                covered[lo - start : hi - start] = True

        out_b = out.view(np.uint8).reshape(n, row_bytes)
        if not covered.all():  # zero only the gaps, by contiguous run
            holes = np.flatnonzero(~covered)
            if holes.size:
                breaks = np.flatnonzero(np.diff(holes) > 1)
                starts_h = np.concatenate([[0], breaks + 1])
                ends_h = np.concatenate([breaks, [holes.size - 1]])
                for a, b in zip(holes[starts_h], holes[ends_h]):
                    out_b[a : b + 1] = 0

        def run(job):
            path, byte_off, dest_row, nrows = job
            fd = os.open(path, os.O_RDONLY)
            try:
                view = memoryview(out_b[dest_row : dest_row + nrows]).cast("B")
                done = 0
                want = nrows * row_bytes
                while done < want:
                    got = os.preadv(fd, [view[done:]], byte_off + done)
                    if got <= 0:
                        raise IOError(f"short read from {path}")
                    done += got
            finally:
                os.close(fd)

        total = sum(j[3] for j in jobs) * row_bytes
        try:
            if len(jobs) <= 1 or total < MIN_PARALLEL_BYTES:
                for j in jobs:
                    run(j)
                return True
            # split very large segments so they spread over the pool
            split: List[Tuple[Path, int, int, int]] = []
            rows_per_job = max(JOB_BYTES // row_bytes, 1)
            for path, off, dest, nrows in jobs:
                while nrows > 0:
                    take = min(nrows, rows_per_job)
                    split.append((path, off, dest, take))
                    off += take * row_bytes
                    dest += take
                    nrows -= take
            pool = self._get_pool()
            # submit + drain EVERY future before returning: Executor.map's
            # exception cleanup cancels only not-yet-started jobs, and an
            # in-flight straggler writing into `out` after a False return
            # would race the caller's per-file fallback refilling the same
            # buffer — silent corruption marked valid by the rebuilt mask
            futs = [pool.submit(run, j) for j in split]
            err: Optional[BaseException] = None
            for f in futs:
                try:
                    f.result()
                except Exception as e:
                    err = e
            if err is not None:
                raise err
            return True
        except Exception:
            # runtime read failure (file truncated/rewritten by a live
            # writer between probe and read): drop the stale maps and let
            # the caller take the per-file path, which re-reads fresh state.
            # Deliberately broad — the fast path is opportunistic and the
            # per-file fallback is the ground truth for ANY failure mode here
            with self._lock:
                self._maps.clear()
            return False

    def _get_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="pstpu-io",
                )
            return self._pool

    def close(self):
        with self._lock:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
                self._pool = None
