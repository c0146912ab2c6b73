"""io.fastread: pooled GIL-free byte-range reads must be byte-identical to
the per-file path, fall back on chunked/compressed files, and actually
engage on large spans. h5py builds the files the package never writes."""

import numpy as np
import pytest

from pyspectrogram_tpu.io import drf_format as fmt
from pyspectrogram_tpu.io.fastread import FastSpanReader
from pyspectrogram_tpu.io.reader import DigitalRFReader
from pyspectrogram_tpu.io.synthetic import write_capture

h5py = pytest.importorskip("h5py")


def _h5py_only(top):
    return DigitalRFReader(top, io_workers=0)


def test_fast_path_engages_on_writer_output(tmp_path):
    """Our writer's files (full-row-width chunks) must be fast-mappable —
    read_into returns True, not a silent h5py fallback."""
    write_capture(tmp_path, channel="e0", kind="tone", n_samples=300_000,
                  sample_rate_numerator=250_000, num_subchannels=2)
    props = fmt.read_properties(tmp_path / "e0" / fmt.PROPERTIES_FILENAME)
    slow = _h5py_only(tmp_path)
    lo, hi = slow.get_bounds("e0")
    n = hi - lo + 1
    out = np.zeros((n, 2), np.complex64)
    mask = np.zeros(n, bool)
    fsr = FastSpanReader()
    assert fsr.read_into(props, tmp_path / "e0", lo, n, out, mask)
    assert mask.all()
    b = slow.read_vector_raw(lo, n, "e0")
    np.testing.assert_array_equal(out, b)


def test_fast_equals_h5py_with_gaps(tmp_path):
    meta = write_capture(
        tmp_path, channel="f0", kind="tone", n_samples=600_000,
        sample_rate_numerator=250_000, num_subchannels=2,
        gap=(200_000, 37_123), noise_rms=1e-3,
    )
    fast = DigitalRFReader(tmp_path)
    slow = _h5py_only(tmp_path)
    assert fast._fast is not None
    lo, hi = fast.get_bounds("f0")
    for start, n in [
        (lo, hi - lo + 1),               # whole capture incl. the gap
        (lo + 150_000, 120_000),          # straddles the gap start
        (lo - 1000, 5000),                # before-bounds zero fill
        (hi - 100, 5000),                 # past-end zero fill
    ]:
        a, ma = fast.read_vector_raw(start, n, "f0", return_mask=True)
        b, mb = slow.read_vector_raw(start, n, "f0", return_mask=True)
        np.testing.assert_array_equal(ma, mb)
        np.testing.assert_array_equal(a, b)


def test_fast_equals_h5py_int16(tmp_path):
    dt = np.dtype([("r", np.int16), ("i", np.int16)])
    write_capture(tmp_path, channel="i0", kind="tone", n_samples=200_000,
                  sample_rate_numerator=100_000, dtype=dt)
    fast = DigitalRFReader(tmp_path)
    slow = _h5py_only(tmp_path)
    lo, hi = fast.get_bounds("i0")
    a = fast.read_vector_raw(lo, hi - lo + 1, "i0")
    b = slow.read_vector_raw(lo, hi - lo + 1, "i0")
    assert a.dtype == dt
    np.testing.assert_array_equal(a, b)


def test_chunked_file_falls_back_to_h5py(tmp_path):
    write_capture(tmp_path, channel="c0", kind="tone", n_samples=300_000,
                  sample_rate_numerator=250_000)
    # rewrite ONE data file chunked+compressed (upstream writers may do
    # this; the fast path must refuse it and the read must still be exact)
    files = fmt.list_data_files(tmp_path / "c0")
    _, victim = files[len(files) // 2]
    with h5py.File(victim, "r") as f:
        data, idx = f["rf_data"][...], f["rf_data_index"][...]
    with h5py.File(victim, "w") as f:
        f.create_dataset("rf_data", data=data, chunks=(1024, 1),
                         compression="gzip")
        f.create_dataset("rf_data_index", data=idx)
    fast = DigitalRFReader(tmp_path)
    slow = _h5py_only(tmp_path)
    lo, hi = fast.get_bounds("c0")
    a, ma = fast.read_vector_raw(lo, hi - lo + 1, "c0", return_mask=True)
    b, mb = slow.read_vector_raw(lo, hi - lo + 1, "c0", return_mask=True)
    assert ma.all()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ma, mb)
    # direct probe of the chunked file must refuse
    props = fmt.read_properties(tmp_path / "c0" / fmt.PROPERTIES_FILENAME)
    fsr = FastSpanReader()
    assert fsr._probe(victim) is None


def test_probe_cache_invalidates_on_rewrite(tmp_path):
    write_capture(tmp_path, channel="r0", kind="tone", n_samples=100_000,
                  sample_rate_numerator=100_000)
    props = fmt.read_properties(tmp_path / "r0" / fmt.PROPERTIES_FILENAME)
    files = fmt.list_data_files(tmp_path / "r0")
    _, p = files[0]
    fsr = FastSpanReader()
    fm1 = fsr._probe(p)
    assert fm1 is not None
    import os
    import time

    time.sleep(0.01)
    with h5py.File(p, "r") as f:
        data, idx = f["rf_data"][...], f["rf_data_index"][...]
    with h5py.File(p, "w") as f:
        f.create_dataset("rf_data", data=data)
        f.create_dataset("rf_data_index", data=idx)
    os.utime(p)  # ensure mtime_ns moves even on coarse filesystems
    fm2 = fsr._probe(p)
    assert fm2 is not None and fm2.mtime_ns != fm1.mtime_ns


def test_big_endian_compound_file_falls_back(tmp_path):
    """Compound dtypes report '|' at the top level even when their FIELDS
    are big-endian; the probe must inspect field byteorder or raw preadv
    would return byte-swapped samples silently (ADVICE r2)."""
    dt_le = np.dtype([("r", "<i2"), ("i", "<i2")])
    write_capture(tmp_path, channel="b0", kind="tone", n_samples=150_000,
                  sample_rate_numerator=100_000, dtype=dt_le)
    files = fmt.list_data_files(tmp_path / "b0")
    _, victim = files[len(files) // 2]
    with h5py.File(victim, "r") as f:
        data, idx = f["rf_data"][...], f["rf_data_index"][...]
        chunks = f["rf_data"].chunks
    dt_be = np.dtype([("r", ">i2"), ("i", ">i2")])
    with h5py.File(victim, "w") as f:
        f.create_dataset("rf_data", data=data.astype(dt_be), chunks=chunks)
        f.create_dataset("rf_data_index", data=idx)
    assert dt_be.byteorder == "|"  # the trap: top-level order is opaque
    props = fmt.read_properties(tmp_path / "b0" / fmt.PROPERTIES_FILENAME)
    assert FastSpanReader()._probe(victim) is None
    # the dataset read must still be exact via the h5py fallback
    fast = DigitalRFReader(tmp_path)
    slow = _h5py_only(tmp_path)
    lo, hi = fast.get_bounds("b0")
    a = fast.read_vector_raw(lo, hi - lo + 1, "b0")
    b = slow.read_vector_raw(lo, hi - lo + 1, "b0")
    np.testing.assert_array_equal(a["r"].astype(np.int32),
                                  b["r"].astype(np.int32))
    np.testing.assert_array_equal(a["i"].astype(np.int32),
                                  b["i"].astype(np.int32))


def test_adjacent_chunk_jobs_coalesce(tmp_path):
    """The writer's bounded chunks (8192 rows) must not multiply preadv
    jobs: byte-adjacent chunk extents merge into single reads."""
    write_capture(tmp_path, channel="j0", kind="noise",
                  n_samples=400_000, sample_rate_numerator=250_000)
    props = fmt.read_properties(tmp_path / "j0" / fmt.PROPERTIES_FILENAME)
    slow = _h5py_only(tmp_path)
    lo, hi = slow.get_bounds("j0")
    n = hi - lo + 1
    out = np.zeros((n, 1), np.complex64)
    fsr = FastSpanReader()
    assert fsr.read_into(props, tmp_path / "j0", lo, n, out)
    np.testing.assert_array_equal(out, slow.read_vector_raw(lo, n, "j0"))


def test_shuffle_filtered_file_falls_back(tmp_path):
    """The shuffle filter is size-preserving, so it passes the chunk-size
    probe — but a raw preadv read of shuffled chunks is byte-permuted
    garbage. The probe must refuse shuffle (and any other size-preserving
    filter) and the read must fall back to h5py, staying exact."""
    write_capture(tmp_path, channel="c0", kind="tone", n_samples=200_000,
                  sample_rate_numerator=250_000)
    files = fmt.list_data_files(tmp_path / "c0")
    _, victim = files[len(files) // 2]
    with h5py.File(victim, "r") as f:
        data, idx = f["rf_data"][...], f["rf_data_index"][...]
    with h5py.File(victim, "w") as f:
        # one chunk == the whole dataset: identical nbytes on disk,
        # bytes shuffled
        f.create_dataset("rf_data", data=data, chunks=data.shape,
                         shuffle=True)
        f.create_dataset("rf_data_index", data=idx)
    fsr = FastSpanReader()
    assert fsr._probe(victim) is None
    fast = DigitalRFReader(tmp_path)
    slow = _h5py_only(tmp_path)
    lo, hi = fast.get_bounds("c0")
    a, ma = fast.read_vector_raw(lo, hi - lo + 1, "c0", return_mask=True)
    b, mb = slow.read_vector_raw(lo, hi - lo + 1, "c0", return_mask=True)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ma, mb)


def test_failed_pool_read_drains_stragglers(tmp_path, monkeypatch):
    """A mid-read failure must DRAIN every in-flight preadv job before
    read_into returns False: Executor.map's cleanup cancels only queued
    jobs, and a straggler writing into ``out`` after the return would
    race the caller's h5py fallback refilling the same buffer (silent
    corruption marked valid)."""
    import os
    import threading
    import time

    write_capture(tmp_path, channel="s0", kind="tone", n_samples=600_000,
                  sample_rate_numerator=250_000, num_subchannels=2)
    props = fmt.read_properties(tmp_path / "s0" / fmt.PROPERTIES_FILENAME)
    slow = _h5py_only(tmp_path)
    lo, hi = slow.get_bounds("s0")
    n = hi - lo + 1

    real = os.preadv
    lock = threading.Lock()
    state = {"calls": 0}

    def flaky(fd, bufs, off):
        with lock:
            state["calls"] += 1
            first = state["calls"] == 1
        if first:
            raise OSError("file truncated mid-read")
        time.sleep(0.05)          # stragglers land late, after the raise
        return real(fd, bufs, off)

    monkeypatch.setattr(os, "preadv", flaky)
    fsr = FastSpanReader()
    out = np.zeros((n, 2), np.complex64)
    mask = np.zeros(n, bool)
    assert not fsr.read_into(props, tmp_path / "s0", lo, n, out, mask)
    snap = out.copy()
    time.sleep(0.3)               # an undrained straggler would write now
    np.testing.assert_array_equal(out, snap)


def test_probe_cache_is_capped(tmp_path, monkeypatch):
    """The per-file probe cache evicts FIFO at MAPS_CAP — a multi-day
    live session must not accumulate one _FileMap per cadence file
    forever — and evicted files still read correctly (re-probe)."""
    from pyspectrogram_tpu.io import fastread

    write_capture(tmp_path, channel="m0", kind="tone", n_samples=500_000,
                  sample_rate_numerator=250_000, file_cadence_millisecs=200)
    monkeypatch.setattr(fastread, "MAPS_CAP", 3)
    fast = DigitalRFReader(tmp_path)
    slow = _h5py_only(tmp_path)
    lo, hi = fast.get_bounds("m0")
    a = fast.read_vector_raw(lo, hi - lo + 1, "m0")   # ~10 files probed
    assert len(fast._fast._maps) <= 3
    b = slow.read_vector_raw(lo, hi - lo + 1, "m0")
    np.testing.assert_array_equal(a, b)
