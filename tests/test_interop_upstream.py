"""Format interoperability with upstream Digital RF, pinned WITHOUT the
upstream package (it is not installable here):

* read direction — captures generated by tests/upstream_capture.py (an
  independent, spec-derived re-creation of the upstream writer's on-disk
  output, including attributes/layouts our writer never produces) must
  read back exactly through our reader;
* write direction — our writer's output must satisfy the structural
  contract the upstream reader requires (required attributes, aligned
  subdir/file naming, per-file sample spans, rf_data_index integrity).

tests/test_io.py keeps the live `digital_rf` round-trip test for
environments where the upstream package exists.
"""

import re
from fractions import Fraction

import numpy as np
import pytest

from pyspectrogram_tpu.io import drf_format as fmt
from pyspectrogram_tpu.io.reader import DigitalRFReader, RFDataset
from pyspectrogram_tpu.io.synthetic import write_capture

from upstream_capture import write_upstream_capture

h5py = pytest.importorskip("h5py")


def test_reads_upstream_golden_continuous_complex64(tmp_path):
    """Continuous complex64 capture at an awkward rational rate, spanning
    several files and a subdir boundary, with upstream's full attribute
    set (uint64 cadences, longdouble samples_per_second, bool_ flags)."""
    sr_num, sr_den = 48_000, 7  # ~6857.14 Hz
    rng = np.random.default_rng(21)
    n = 40_000
    data = (rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
            ).astype(np.complex64)
    g0 = int(1_451_661_839 * Fraction(sr_num, sr_den))  # lands mid-subdir
    write_upstream_capture(
        tmp_path, "up0", [(g0, data)], sr_num=sr_num, sr_den=sr_den,
        subdir_cadence_secs=2, file_cadence_millisecs=250,
    )
    rd = DigitalRFReader(tmp_path)
    assert rd.get_channels() == ["up0"]
    props = rd.get_properties("up0")
    assert props["sample_rate_numerator"] == sr_num
    assert props["sample_rate_denominator"] == sr_den
    assert props["is_complex"] and props["num_subchannels"] == 2
    assert fmt.get_ref(props) == 1.0  # float data -> full scale 1.0
    assert rd.get_bounds("up0") == (g0, g0 + n - 1)
    got = rd.read_vector(g0, n, "up0")
    np.testing.assert_array_equal(got.astype(np.complex64), data)
    # arbitrary interior window crossing file boundaries
    got2 = rd.read_vector(g0 + 12_345, 10_000, "up0")
    np.testing.assert_array_equal(
        got2.astype(np.complex64), data[12_345:22_345])


def test_reads_upstream_golden_gapped_int16(tmp_path):
    """Non-continuous complex-int16 capture with gaps inside and across
    files: zero-fill + validity mask, multi-run rf_data_index files, and
    the integer dBFS rule 2**15.5."""
    sr = 100_000
    dt = np.dtype([("r", np.int16), ("i", np.int16)])
    rng = np.random.default_rng(22)

    def blk(g, n):
        a = np.zeros((n, 1), dtype=dt)
        a["r"] = rng.integers(-3000, 3000, (n, 1))
        a["i"] = rng.integers(-3000, 3000, (n, 1))
        return g, a

    g0 = 1_451_661_840 * sr
    # gap of 50 samples inside one file span, then a cross-file gap of 77k
    blocks = [blk(g0, 10_000), blk(g0 + 10_050, 5_000), blk(g0 + 92_000, 8_000)]
    write_upstream_capture(
        tmp_path, "gap0", blocks, sr_num=sr, is_continuous=False,
        subdir_cadence_secs=4, file_cadence_millisecs=500,
    )
    rd = DigitalRFReader(tmp_path)
    props = rd.get_properties("gap0")
    assert fmt.get_ref(props) == 2 ** 15.5
    lo, hi = rd.get_bounds("gap0")
    assert (lo, hi) == (g0, g0 + 92_000 + 8_000 - 1)
    span = 100_000
    raw, mask = rd.read_vector_raw(g0, span, "gap0", return_mask=True)
    assert raw.dtype == dt
    expect_mask = np.zeros(span, bool)
    for g, a in blocks:
        expect_mask[g - g0 : g - g0 + len(a)] = True
    np.testing.assert_array_equal(mask, expect_mask)
    assert (raw["r"][~mask] == 0).all() and (raw["i"][~mask] == 0).all()
    for g, a in blocks:
        np.testing.assert_array_equal(raw[g - g0 : g - g0 + len(a)], a)
    # contiguous-runs API mirrors upstream read(): one run per block
    runs = rd.read(g0, span, "gap0")
    assert list(runs) == [g for g, _ in blocks]


def test_rfdataset_sti_over_upstream_golden(tmp_path):
    """The full ingest layer (RFDataset -> read_sti) consumes an
    upstream-shaped capture; gap columns come back masked."""
    sr = 1_000_000
    n = 1 << 15
    t = np.arange(n) / sr
    tone = np.exp(2j * np.pi * 125_000 * t).astype(np.complex64)[:, None]
    g0 = 1_451_661_840 * sr
    # one gap in the middle third
    blocks = [(g0, tone[: n // 3]), (g0 + n // 2, tone[n // 2 :])]
    write_upstream_capture(tmp_path, "sti0", blocks, sr_num=sr,
                           is_continuous=False)
    ds = RFDataset(tmp_path)
    assert list(ds.chan_2sub["sti0"]) == [0]
    assert ds.sr_dict["sti0"] == Fraction(sr)
    lo, hi = ds.bnds["sti0"]
    n_st, block = ds.read_sti(lo, "sti0", hi, 512, 1, 16)
    assert block.shape == (512, 16, 1)


def _required_upstream_attrs():
    """Attributes the upstream reader's property parser requires."""
    return [
        "H5Tget_class", "H5Tget_size", "H5Tget_precision", "H5Tget_offset",
        "subdir_cadence_secs", "file_cadence_millisecs",
        "sample_rate_numerator", "sample_rate_denominator",
        "is_complex", "num_subchannels", "is_continuous", "epoch",
        "digital_rf_version",
    ]


def test_writer_output_satisfies_upstream_reader_contract(tmp_path):
    """Structural contract: everything the upstream reader needs must be
    present and internally consistent in our writer's output."""
    meta = write_capture(
        tmp_path, channel="w0", kind="tone", n_samples=1_000_000,
        sample_rate_numerator=250_000, num_subchannels=2,
        dtype=np.complex64,
    )  # 4 s of data -> spans several files at the default cadence
    chan_dir = tmp_path / "w0"
    with h5py.File(chan_dir / "drf_properties.h5", "r") as f:
        for k in _required_upstream_attrs():
            assert k in f.attrs, f"missing required upstream attr {k}"
        num = int(f.attrs["sample_rate_numerator"])
        den = int(f.attrs["sample_rate_denominator"])
        sub_cad = int(f.attrs["subdir_cadence_secs"])
        file_cad = int(f.attrs["file_cadence_millisecs"])
        nsub = int(f.attrs["num_subchannels"])
        assert int(f.attrs["is_complex"]) == 1
        assert sub_cad * 1000 % file_cad == 0

    name_re = re.compile(r"^rf@(\d+)\.(\d{3})\.h5$")
    subdir_re = re.compile(r"^\d{4}-\d{2}-\d{2}T\d{2}-\d{2}-\d{2}$")
    nfiles = 0
    prev_end_g = None
    for sub in sorted(p for p in chan_dir.iterdir() if p.is_dir()):
        assert subdir_re.match(sub.name), sub.name
        import datetime as _dt

        sub_s = int(_dt.datetime.strptime(
            sub.name, "%Y-%m-%dT%H-%M-%S").replace(
            tzinfo=_dt.timezone.utc).timestamp())
        assert sub_s % sub_cad == 0, "subdir not cadence-aligned"
        for p in sorted(sub.iterdir()):
            m = name_re.match(p.name)
            assert m, p.name
            file_ms = int(m.group(1)) * 1000 + int(m.group(2))
            assert file_ms % file_cad == 0, "file not cadence-aligned"
            assert sub_s <= file_ms // 1000 < sub_s + sub_cad
            with h5py.File(p, "r") as f:
                data = f["rf_data"]
                idx = f["rf_data_index"][...]
                assert data.shape[1] == nsub
                assert idx.dtype == np.uint64 and idx.ndim == 2
                assert idx.shape[1] == 2
                # complex stored as the upstream {r, i} compound; h5py
                # presents a float {r, i} compound as native complex, so
                # complex kind here implies the on-disk compound uses
                # exactly the upstream field names
                assert data.dtype.kind == "c" or set(
                    data.dtype.names) == {"r", "i"}
                # index integrity: ascending, first row 0, rows in range,
                # and every indexed sample lies inside this file's span
                assert idx[0, 1] == 0
                assert (np.diff(idx[:, 0].astype(np.int64)) > 0).all()
                assert (np.diff(idx[:, 1].astype(np.int64)) > 0).all()
                assert idx[-1, 1] < data.shape[0]
                span_lo = -((-file_ms * num) // (1000 * den))   # ceil
                span_hi = -((-(file_ms + file_cad) * num) // (1000 * den))
                for k in range(len(idx)):
                    g, r = int(idx[k, 0]), int(idx[k, 1])
                    r1 = int(idx[k + 1, 1]) if k + 1 < len(idx) else data.shape[0]
                    assert span_lo <= g and g + (r1 - r) <= span_hi, (
                        "samples outside the file's cadence span")
                    if prev_end_g is not None:
                        assert g >= prev_end_g, "overlapping sample ranges"
                    prev_end_g = g + (r1 - r)
            nfiles += 1
    assert nfiles >= 2, "expected the capture to span multiple files"
    # and of course we read our own writing exactly
    rd = DigitalRFReader(tmp_path)
    lo, hi = rd.get_bounds("w0")
    assert hi - lo + 1 == meta["n_samples"]
