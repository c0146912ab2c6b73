"""io.h5lite: the h5py-free HDF5 subset the Digital RF main path needs.

h5py (present in the test environment, optional at run time) is the
independent check in both directions: it must read what h5lite writes,
and h5lite must read what h5py writes by default.
"""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from pyspectrogram_tpu.io import h5lite  # noqa: E402

CF = np.dtype([("r", "<f4"), ("i", "<f4")])
CI = np.dtype([("r", "<i2"), ("i", "<i2")])


def _data_file(path, dtype, ncols, chunk_rows):
    h5lite.create(path, datasets=(("rf_data", dtype, ncols, chunk_rows),
                                  ("rf_data_index", np.dtype("<u8"), 2, 4)))


def test_attrs_roundtrip_through_h5py(tmp_path):
    p = tmp_path / "props.h5"
    attrs = {"n": 7, "big": np.uint64(2 ** 63 + 5), "rate": 2.5e6,
             "neg": np.int16(-3), "epoch": "1970-01-01T00:00:00Z"}
    h5lite.create(p, attrs=attrs)
    with h5py.File(p, "r") as f:
        assert int(f.attrs["n"]) == 7
        assert int(f.attrs["big"]) == 2 ** 63 + 5
        assert float(f.attrs["rate"]) == 2.5e6
        assert int(f.attrs["neg"]) == -3
        assert f.attrs["epoch"] == b"1970-01-01T00:00:00Z"
        assert len(f) == 0
    with h5lite.File(p) as f:
        assert f.attrs == {"n": 7, "big": 2 ** 63 + 5, "rate": 2.5e6,
                           "neg": -3, "epoch": "1970-01-01T00:00:00Z"}


@pytest.mark.parametrize("dtype,chunk_rows,nblocks", [
    (CF, 5, 40),          # 2-level chunk B-tree (> 64 chunks)
    (CI, 1, 80),          # 3-level chunk B-tree (> 4096 chunks)
    (np.dtype("<f8"), 8192, 3),
])
def test_appends_read_back_through_h5py_and_h5lite(tmp_path, dtype,
                                                   chunk_rows, nblocks):
    p = tmp_path / "d.h5"
    _data_file(p, dtype, 2, chunk_rows)
    rng = np.random.default_rng(0)
    parts = []
    for k in range(nblocks):
        n = int(rng.integers(1, 120))
        rows = rng.integers(-1000, 1000, (n, 2 * (dtype.itemsize // (
            dtype["r"].itemsize if dtype.names else dtype.itemsize)))
                            ).astype(np.float64)
        block = np.zeros((n, 2), dtype)
        if dtype.names:
            block["r"], block["i"] = rows[:, 0:2], rows[:, 2:4]
        else:
            block[:] = rows
        parts.append(block)
        with h5lite.File(p, "a") as f:
            f.append("rf_data", block)
            f.append("rf_data_index", np.array([[1000 * k, k]], np.uint64))
    want = np.concatenate(parts)
    want_mem = want.view(h5lite.memory_dtype(dtype))
    with h5py.File(p, "r") as f:
        np.testing.assert_array_equal(f["rf_data"][...], want_mem)
        assert f["rf_data"].chunks == (chunk_rows, 2)
        assert f["rf_data"].maxshape == (None, 2)
        assert f["rf_data_index"].shape == (nblocks, 2)
    with h5lite.File(p) as f:
        ds = f["rf_data"]
        assert ds.dtype == want_mem.dtype and ds.shape == want.shape
        np.testing.assert_array_equal(ds[...], want_mem)
        np.testing.assert_array_equal(ds[3:len(want) - 3],
                                      want_mem[3:len(want) - 3])
        np.testing.assert_array_equal(f["rf_data_index"][-1],
                                      [1000 * (nblocks - 1), nblocks - 1])
        assert f["rf_data_index"][0, 1] == 0


def test_reads_h5py_default_files(tmp_path):
    """Contiguous datasets, many attributes (continuation blocks),
    variable-length strings and bool enums, as h5py writes them."""
    p = tmp_path / "h.h5"
    x = (np.arange(40, dtype=np.float32).reshape(20, 2)
         + 1j * np.ones((20, 2), np.float32)).astype(np.complex64)
    with h5py.File(p, "w") as f:
        f.create_dataset("rf_data", data=x)
        f.create_dataset("rf_data_index", data=np.array([[5, 0]], np.uint64))
        f.attrs["s"] = "hello"
        f.attrs["flag"] = np.bool_(True)
        f.attrs["wide"] = np.longdouble(1.5)   # skipped, others still read
        for i in range(40):
            f.attrs[f"a{i}"] = i
    with h5lite.File(p) as f:
        assert f["rf_data"].chunks is None
        np.testing.assert_array_equal(f["rf_data"][...], x)
        assert f.attrs["s"] == "hello" and f.attrs["flag"] == 1
        assert "wide" not in f.attrs
        assert [f.attrs[f"a{i}"] for i in range(40)] == list(range(40))


@pytest.mark.parametrize("kind", ["gzip", "split_chunks", "big_endian"])
def test_unsupported_layouts_raise_and_open_file_falls_back(tmp_path, kind):
    p = tmp_path / "u.h5"
    x = np.arange(64, dtype=np.int16).reshape(32, 2)
    with h5py.File(p, "w") as f:
        if kind == "gzip":
            f.create_dataset("rf_data", data=x, chunks=(8, 2),
                             compression="gzip")
        elif kind == "split_chunks":
            f.create_dataset("rf_data", data=x, chunks=(8, 1))
        else:
            f.create_dataset("rf_data", data=x.astype(">i2"))
    with h5lite.File(p) as f:
        with pytest.raises(h5lite.Unsupported):
            f["rf_data"].extents()
    with h5lite.open_file(p) as f:        # h5py takes over
        np.testing.assert_array_equal(f["rf_data"][...], x)


def test_open_file_without_h5py_names_the_missing_package(tmp_path,
                                                          monkeypatch):
    import builtins

    p = tmp_path / "g.h5"
    with h5py.File(p, "w") as f:
        f.create_dataset("rf_data", data=np.zeros((4, 1)), chunks=(2, 1),
                         compression="gzip")
    real_import = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == "h5py":
            raise ImportError("no h5py")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(h5lite.Unsupported, match="install h5py"):
        h5lite.open_file(p)


def test_reader_sees_old_or_new_extent_never_torn(tmp_path):
    """A dataset opened before an append keeps a consistent old view (the
    append writes new chunks and a new B-tree, never the old structures);
    a handle opened after sees every appended row."""
    p = tmp_path / "c.h5"
    _data_file(p, CI, 1, 4)
    first = np.zeros((6, 1), CI)
    first["r"] = np.arange(6).reshape(6, 1)
    with h5lite.File(p, "a") as f:
        f.append("rf_data", first)
    old = h5lite.File(p)
    old_ds = old["rf_data"]
    second = np.zeros((9, 1), CI)
    second["r"] = 100 + np.arange(9).reshape(9, 1)
    with h5lite.File(p, "a") as f:
        f.append("rf_data", second)
    np.testing.assert_array_equal(old_ds[...], first)
    old.close()
    with h5lite.File(p) as f:
        np.testing.assert_array_equal(f["rf_data"][...],
                                      np.concatenate([first, second]))
