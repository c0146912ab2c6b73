"""Minimal pure-NumPy HDF5 reader and writer for the Digital RF subset.

The package's main path needs exactly this much of HDF5:

* root-group attributes (``drf_properties.h5``): integers, floats and
  strings;
* two resizable, uncompressed, chunked 2-D datasets per data file
  (``rf_data`` with full-row-width chunks, ``rf_data_index``), appended
  row-wise while readers may be polling the file.

Files written here use the oldest on-disk structures (superblock v0,
version-1 object headers, symbol-table groups, version-1 B-tree chunk
indexes), which every HDF5 library and ``h5py`` read. The reader handles
the same structures as ``h5py`` writes them by default (contiguous
datasets, continuation blocks, variable-length string and enum
attributes) and raises :class:`Unsupported` for anything else —
compression and other filters, partial-width chunks, newer object-header
versions. :func:`open_file` then falls back to ``h5py`` when it is
installed, so ``h5py`` is an optional dependency kept for upstream
captures that use such features.

Appends never rewrite a structure a concurrent reader may be walking: new
chunks and a rebuilt chunk B-tree go to the end of the file, then the
8-byte B-tree address and the dataset extent are patched in place, index
dataset first, so a reader sees either the old file or a consistent
newer one (at worst a last run that is still empty).
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
UNLIMITED = UNDEF

# node capacities fixed by the version-0 superblock written here (the
# library defaults, which readers also assume for v0 files)
GROUP_LEAF_K = 4
GROUP_INTERNAL_K = 16
CHUNK_K = 32

_MSG_DATASPACE = 0x0001
_MSG_DATATYPE = 0x0003
_MSG_FILL = 0x0005
_MSG_LAYOUT = 0x0008
_MSG_PIPELINE = 0x000B
_MSG_ATTRIBUTE = 0x000C
_MSG_CONTINUATION = 0x0010
_MSG_SYMBOL_TABLE = 0x0011


class H5Error(OSError):
    """The file is not readable as HDF5 (truncated, mid-write, corrupt)."""


class Unsupported(H5Error):
    """Valid HDF5 that uses a feature outside this module's subset."""


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# --------------------------------------------------------------- datatypes
def _decode_dtype(b: bytes, p: int) -> Tuple[object, int]:
    """Datatype message at b[p:] -> (numpy dtype or "vlen_str", length)."""
    cv = b[p]
    cls, ver = cv & 0x0F, cv >> 4
    bits = b[p + 1] | (b[p + 2] << 8) | (b[p + 3] << 16)
    size = struct.unpack_from("<I", b, p + 4)[0]
    if cls == 0:                                   # fixed point
        order = ">" if bits & 1 else "<"
        kind = "i" if bits & 8 else "u"
        if size not in (1, 2, 4, 8):
            raise Unsupported(f"integer of {size} bytes")
        return np.dtype(f"{order}{kind}{size}"), 12
    if cls == 1:                                   # floating point
        if bits & 0x40 or size not in (2, 4, 8):
            raise Unsupported(f"float of {size} bytes")
        return np.dtype(f"{'>' if bits & 1 else '<'}f{size}"), 20
    if cls == 3:                                   # fixed-length string
        return np.dtype(f"S{size}"), 8
    if cls == 6:                                   # compound
        names, formats, offsets = [], [], []
        q = p + 8
        for _ in range(bits & 0xFFFF):
            end = b.index(b"\0", q)
            names.append(b[q:end].decode())
            q = q + _pad8(end - q + 1) if ver < 3 else end + 1
            if ver < 3:
                offsets.append(struct.unpack_from("<I", b, q)[0])
                q += 32 if ver == 1 else 4
            else:
                nb = max(1, (size.bit_length() + 7) // 8)
                offsets.append(int.from_bytes(b[q:q + nb], "little"))
                q += nb
            mdt, n = _decode_dtype(b, q)
            if not isinstance(mdt, np.dtype):
                raise Unsupported("variable-length compound member")
            formats.append(mdt)
            q += n
        return np.dtype({"names": names, "formats": formats,
                         "offsets": offsets, "itemsize": size}), q - p
    if cls == 8:                                   # enumeration (h5py bool)
        base, n = _decode_dtype(b, p + 8)
        q = p + 8 + n
        for _ in range(bits & 0xFFFF):
            end = b.index(b"\0", q)
            q = q + _pad8(end - q + 1) if ver < 3 else end + 1
        return base, q + (bits & 0xFFFF) * base.itemsize - p
    if cls == 9 and bits & 0xF == 1:               # variable-length string
        _, n = _decode_dtype(b, p + 8)
        return "vlen_str", 8 + n
    raise Unsupported(f"datatype class {cls}")


def _encode_dtype(dt: np.dtype) -> bytes:
    """Version-1 datatype message for a little-endian integer, float,
    fixed-length string or compound of those."""
    dt = np.dtype(dt)
    if dt.names is not None:
        body = b""
        for name in dt.names:
            mdt, off = dt.fields[name][:2]
            nm = name.encode() + b"\0"
            body += nm.ljust(_pad8(len(nm)), b"\0")
            body += struct.pack("<IB3xI4x16x", off, 0, 0)
            body += _encode_dtype(mdt)
        return struct.pack("<B3sI", 0x16, len(dt.names).to_bytes(3, "little"),
                           dt.itemsize) + body
    if dt.byteorder == ">":
        raise ValueError("only little-endian types are written")
    if dt.kind in "iu":
        flags = 0x08 if dt.kind == "i" else 0
        return struct.pack("<B3sIHH", 0x10, bytes([flags, 0, 0]), dt.itemsize,
                           0, 8 * dt.itemsize)
    if dt.kind == "f":
        exp_bits, man_bits, bias = {4: (8, 23, 127), 8: (11, 52, 1023)}[
            dt.itemsize]
        nbits = 8 * dt.itemsize
        return struct.pack("<B3sIHHBBBBI", 0x11,
                           bytes([0x20, nbits - 1, 0]), dt.itemsize, 0, nbits,
                           man_bits, exp_bits, 0, man_bits, bias)
    if dt.kind == "S":
        return struct.pack("<B3sI", 0x13, bytes([1, 0, 0]), dt.itemsize)
    raise ValueError(f"cannot encode dtype {dt}")


def memory_dtype(storage: np.dtype) -> np.dtype:
    """What a read yields, as h5py presents it: a little-endian float
    compound {r, i} is native complex; everything else is unchanged."""
    if (storage.names == ("r", "i") and storage["r"] == storage["i"]
            and storage["r"].kind == "f" and storage["r"].byteorder != ">"
            and storage.fields["i"][1] == storage["r"].itemsize
            and storage.itemsize == 2 * storage["r"].itemsize):
        return np.dtype(f"c{storage.itemsize}")
    return storage


# -------------------------------------------------------------- dataspace
def _decode_dataspace(b: bytes, p: int) -> Tuple[tuple, Optional[tuple]]:
    ver, rank, flags = b[p], b[p + 1], b[p + 2]
    if ver == 1:
        q = p + 8
    elif ver == 2:
        q = p + 4
    else:
        raise Unsupported(f"dataspace version {ver}")
    dims = struct.unpack_from(f"<{rank}Q", b, q)
    maxd = (struct.unpack_from(f"<{rank}Q", b, q + 8 * rank)
            if flags & 1 else None)
    return tuple(dims), maxd


def _encode_dataspace(dims: tuple, maxdims: Optional[tuple] = None) -> bytes:
    out = struct.pack("<BBB5x", 1, len(dims), 1 if maxdims else 0)
    out += struct.pack(f"<{len(dims)}Q", *dims)
    if maxdims:
        out += struct.pack(f"<{len(maxdims)}Q", *maxdims)
    return out


# ----------------------------------------------------------------- reader
class Dataset:
    """A 2-D dataset: h5py-style ``shape``, ``dtype``, ``chunks`` and
    row slicing (``ds[a:b]``, ``ds[...]``, ``ds[-1]``)."""

    def __init__(self, f: "File", name: str, msgs: list):
        self._f, self.name = f, name
        self.filtered = False
        layout = None
        for mtype, pos, body in msgs:
            if mtype == _MSG_DATASPACE:
                self.shape, self.maxshape = _decode_dataspace(body, 0)
                self._dims_pos = pos + (8 if body[0] == 1 else 4)
            elif mtype == _MSG_DATATYPE:
                self.storage_dtype, _ = _decode_dtype(body, 0)
            elif mtype == _MSG_LAYOUT:
                layout, self._layout_pos = body, pos
            elif mtype == _MSG_PIPELINE:
                self.filtered = True
        if layout is None or not hasattr(self, "shape"):
            raise H5Error(f"{name}: not a dataset")
        if not isinstance(self.storage_dtype, np.dtype):
            raise Unsupported(f"{name}: variable-length data")
        if len(self.shape) != 2:
            raise Unsupported(f"{name}: rank {len(self.shape)}")
        self.dtype = memory_dtype(self.storage_dtype)
        self.row_bytes = self.storage_dtype.itemsize * self.shape[1]
        if layout[0] != 3:
            raise Unsupported(f"{name}: layout version {layout[0]}")
        if layout[1] == 1:                               # contiguous
            self.chunks = None
            self.contiguous_addr = struct.unpack_from("<Q", layout, 2)[0]
            self.chunk_addrs: Dict[int, Tuple[int, int, int]] = {}
        elif layout[1] == 2:                             # chunked
            ndims = layout[2]
            self._btree_pos = self._layout_pos + 3
            btree = struct.unpack_from("<Q", layout, 3)[0]
            cdims = struct.unpack_from(f"<{ndims}I", layout, 11)
            self.chunks = tuple(cdims[:-1])
            self.chunk_addrs = {} if btree == UNDEF else f._chunk_btree(
                btree, ndims)
        else:
            raise Unsupported(f"{name}: compact layout")

    def readable(self) -> bool:
        """Rows map to plain byte ranges (no filter, full-width chunks,
        native byte order) — the subset this module reads and appends."""
        fields = ([self.storage_dtype[n] for n in self.storage_dtype.names]
                  if self.storage_dtype.names else [self.storage_dtype])
        return (not self.filtered
                and all(d.byteorder != ">" for d in fields)
                and (self.chunks is None or self.chunks[1] == self.shape[1]))

    def extents(self) -> Tuple[int, np.ndarray]:
        """(chunk_rows, byte offset of each chunk, -1 = unallocated)."""
        if not self.readable():
            raise Unsupported(f"{self.name}: filtered or split chunks")
        n = self.shape[0]
        if self.chunks is None:
            if self.contiguous_addr == UNDEF:
                return max(n, 1), np.full(1 if n else 0, -1, np.int64)
            return max(n, 1), np.asarray([self.contiguous_addr], np.int64)
        cr = self.chunks[0]
        offs = np.full(-(-n // cr), -1, np.int64)
        size = cr * self.row_bytes
        for row, (addr, nbytes, fmask) in self.chunk_addrs.items():
            if fmask or nbytes != size:
                raise Unsupported(f"{self.name}: filtered chunk")
            if row // cr < len(offs):
                offs[row // cr] = addr
        return cr, offs

    def read_rows(self, a: int, b: int) -> np.ndarray:
        a, b = max(0, a), min(b, self.shape[0])
        out = np.zeros((max(0, b - a), self.shape[1]), self.storage_dtype)
        if b <= a:
            return out.view(self.dtype)
        cr, offs = self.extents()
        raw = out.view(np.uint8).reshape(b - a, self.row_bytes)
        r = a
        while r < b:
            ci = r // cr
            take = min(b, (ci + 1) * cr) - r
            if offs[ci] >= 0:
                raw[r - a:r - a + take] = np.frombuffer(self._f._read(
                    int(offs[ci]) + (r - ci * cr) * self.row_bytes,
                    take * self.row_bytes), np.uint8).reshape(take, -1)
            r += take
        return out.view(self.dtype)

    def __getitem__(self, key):
        if isinstance(key, tuple):                     # ds[rows, cols]
            rows = self[key[0]]
            if isinstance(key[0], (int, np.integer)):
                return rows[key[1:]]
            return rows[(slice(None),) + key[1:]]
        if key is Ellipsis:
            return self.read_rows(0, self.shape[0])
        if isinstance(key, slice):
            a, b, step = key.indices(self.shape[0])
            if step != 1:
                raise IndexError("strided slices are not supported")
            return self.read_rows(a, b)
        if isinstance(key, (int, np.integer)):
            k = int(key) + (self.shape[0] if key < 0 else 0)
            if not 0 <= k < self.shape[0]:
                raise IndexError(key)
            return self.read_rows(k, k + 1)[0]
        raise IndexError(f"unsupported index {key!r}")


class File:
    """Read (``mode="r"``) or append (``mode="a"``) an HDF5 file in the
    subset above. Mirrors the slice of h5py's API the package uses:
    ``f.attrs``, ``f[name]``, ``name in f``, context management."""

    def __init__(self, path, mode: str = "r"):
        self.path = Path(path)
        self._fd = os.open(self.path, os.O_RDWR if mode == "a" else os.O_RDONLY)
        try:
            self._open()
        except BaseException:
            os.close(self._fd)
            raise
        self._dirty: Dict[str, Dataset] = {}
        self._btree_dirty: set = set()

    # -- low-level ------------------------------------------------------
    def _read(self, addr: int, n: int) -> bytes:
        b = os.pread(self._fd, n, addr)
        if len(b) != n:
            raise H5Error(f"{self.path}: short read at {addr}")
        return b

    def _open(self) -> None:
        sb = self._read(0, 96)
        if sb[:8] != SIGNATURE:
            raise Unsupported(f"{self.path}: no HDF5 superblock at offset 0")
        if sb[8] != 0 or sb[13] != 8 or sb[14] != 8:
            raise Unsupported(f"{self.path}: superblock version {sb[8]}")
        base, _, self._eof, _ = struct.unpack_from("<4Q", sb, 24)
        if base != 0:
            raise Unsupported(f"{self.path}: nonzero base address")
        root_hdr = struct.unpack_from("<Q", sb, 56 + 8)[0]
        self._root_msgs = self._header(root_hdr)
        self.attrs: Dict[str, object] = {}
        self._members: Dict[str, int] = {}
        for mtype, _, body in self._root_msgs:
            if mtype == _MSG_ATTRIBUTE:
                try:
                    name, value = self._decode_attr(body)
                except Unsupported:
                    continue  # e.g. long-double attrs: skip, keep the rest
                self.attrs[name] = value
            elif mtype == _MSG_SYMBOL_TABLE:
                btree, heap = struct.unpack_from("<QQ", body, 0)
                self._members = self._group_members(btree, heap)
        self._datasets: Dict[str, Dataset] = {}

    def _header(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """Messages of a version-1 object header: (type, body addr, body)."""
        pre = self._read(addr, 16)
        if pre[0] != 1:
            raise Unsupported(f"{self.path}: object header version {pre[0]}")
        size = struct.unpack_from("<I", pre, 8)[0]
        blocks, msgs = [(addr + 16, size)], []
        while blocks:
            baddr, blen = blocks.pop(0)
            blk = self._read(baddr, blen)
            p = 0
            while p + 8 <= blen:
                mtype, msize, mflags = struct.unpack_from("<HHB", blk, p)
                body = blk[p + 8:p + 8 + msize]
                if mtype == _MSG_CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", body, 0))
                elif mtype and mflags & 0x02:
                    raise Unsupported(f"{self.path}: shared message")
                elif mtype:
                    msgs.append((mtype, baddr + p + 8, body))
                p += 8 + msize
        return msgs

    def _btree_node(self, addr: int, node_type: int):
        hdr = self._read(addr, 24)
        if hdr[:4] != b"TREE" or hdr[4] != node_type:
            raise H5Error(f"{self.path}: bad B-tree node at {addr}")
        return hdr[5], struct.unpack_from("<H", hdr, 6)[0]

    def _group_members(self, btree: int, heap: int) -> Dict[str, int]:
        h = self._read(heap, 32)
        if h[:4] != b"HEAP":
            raise H5Error(f"{self.path}: bad local heap")
        seg_size, _, seg_addr = struct.unpack_from("<QQQ", h, 8)
        names = self._read(seg_addr, seg_size)
        out: Dict[str, int] = {}

        def walk(addr):
            level, n = self._btree_node(addr, 0)
            body = self._read(addr + 24, 8 * (2 * n + 1))
            for i in range(n):
                child = struct.unpack_from("<Q", body, 8 + 16 * i)[0]
                if level:
                    walk(child)
                    continue
                snod = self._read(child, 8)
                if snod[:4] != b"SNOD":
                    raise H5Error(f"{self.path}: bad symbol node")
                nsym = struct.unpack_from("<H", snod, 6)[0]
                ents = self._read(child + 8, 40 * nsym)
                for k in range(nsym):
                    off, hdr = struct.unpack_from("<QQ", ents, 40 * k)
                    out[names[off:names.index(b"\0", off)].decode()] = hdr

        walk(btree)
        return out

    def _chunk_btree(self, addr: int, ndims: int
                     ) -> Dict[int, Tuple[int, int, int]]:
        """{first row of chunk: (addr, stored bytes, filter mask)}."""
        ksize = 8 + 8 * ndims
        out: Dict[int, Tuple[int, int, int]] = {}

        def walk(a):
            level, n = self._btree_node(a, 1)
            body = self._read(a + 24, n * (ksize + 8) + ksize)
            for i in range(n):
                k = i * (ksize + 8)
                size, fmask = struct.unpack_from("<II", body, k)
                offs = struct.unpack_from(f"<{ndims}Q", body, k + 8)
                child = struct.unpack_from("<Q", body, k + ksize)[0]
                if level:
                    walk(child)
                elif any(offs[1:]):
                    raise Unsupported(f"{self.path}: split-column chunks")
                else:
                    out[offs[0]] = (child, size, fmask)

        walk(addr)
        return out

    def _decode_attr(self, body: bytes) -> Tuple[str, object]:
        ver = body[0]
        if ver not in (1, 2, 3):
            raise Unsupported(f"attribute version {ver}")
        nlen, dlen, slen = struct.unpack_from("<HHH", body, 2)
        p = 8 if ver < 3 else 9
        align = _pad8 if ver == 1 else (lambda n: n)
        name = body[p:p + nlen].split(b"\0", 1)[0].decode()
        p += align(nlen)
        dt, _ = _decode_dtype(body, p)
        p += align(dlen)
        shape, _ = _decode_dataspace(body, p)
        p += align(slen)
        count = int(np.prod(shape)) if shape else 1
        if dt == "vlen_str":
            vals = []
            for i in range(count):
                n, gcol, idx = struct.unpack_from("<IQI", body, p + 16 * i)
                vals.append(self._global_heap(gcol, idx)[:n].decode())
            value = vals[0] if not shape else np.array(vals, object)
        else:
            arr = np.frombuffer(body, dt, count, p)
            if dt.kind == "S":
                arr = np.char.decode(np.char.rstrip(arr, b"\0"))
            value = arr[0] if not shape else arr.reshape(shape)
        if isinstance(value, np.str_):
            value = str(value)
        return name, value

    def _global_heap(self, addr: int, index: int) -> bytes:
        h = self._read(addr, 16)
        if h[:4] != b"GCOL":
            raise H5Error(f"{self.path}: bad global heap")
        size = struct.unpack_from("<Q", h, 8)[0]
        col = self._read(addr, size)
        p = 16
        while p + 16 <= size:
            idx, _, osize = struct.unpack_from("<HH4xQ", col, p)
            if idx == 0:
                break
            if idx == index:
                return col[p + 16:p + 16 + osize]
            p += 16 + _pad8(osize)
        raise H5Error(f"{self.path}: global heap object {index} missing")

    # -- h5py-style surface ----------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._members

    def __getitem__(self, name: str) -> Dataset:
        ds = self._datasets.get(name)
        if ds is None:
            if name not in self._members:
                raise KeyError(name)
            ds = Dataset(self, name, self._header(self._members[name]))
            self._datasets[name] = ds
        return ds

    def close(self) -> None:
        if self._fd < 0:
            return
        try:
            if self._dirty:
                self._commit()
        finally:
            os.close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- append ------------------------------------------------------------
    def _alloc(self, n: int) -> int:
        addr = _pad8(self._eof)
        self._eof = addr + n
        return addr

    def append(self, name: str, rows: np.ndarray) -> None:
        """Append rows to a chunked dataset opened with ``mode="a"``."""
        ds = self[name]
        if ds.chunks is None or not ds.readable():
            raise Unsupported(f"{name}: not appendable")
        rows = np.ascontiguousarray(rows, ds.storage_dtype)
        if rows.ndim != 2 or rows.shape[1] != ds.shape[1]:
            raise ValueError(f"{name}: expected (n, {ds.shape[1]}) rows")
        cr, rb = ds.chunks[0], ds.row_bytes
        raw = rows.view(np.uint8).reshape(len(rows), rb)
        r, end = ds.shape[0], ds.shape[0] + len(rows)
        while r < end:
            ci = r // cr
            take = min(end, (ci + 1) * cr) - r
            if ci * cr not in ds.chunk_addrs:
                ds.chunk_addrs[ci * cr] = (self._alloc(cr * rb), cr * rb, 0)
                self._btree_dirty.add(name)
            addr = ds.chunk_addrs[ci * cr][0] + (r - ci * cr) * rb
            src = raw[r - ds.shape[0]:r - ds.shape[0] + take]
            if os.pwrite(self._fd, memoryview(src).cast("B"), addr) != src.nbytes:
                raise H5Error(f"{self.path}: short write")
            r += take
        ds.shape = (end, ds.shape[1])
        self._dirty[name] = ds

    def _commit(self) -> None:
        """Publish appended rows: B-trees, then EOF, then the extents
        (index dataset first — see the module docstring)."""
        patches = []
        for name in sorted(self._btree_dirty):
            ds = self._dirty[name]
            root = _write_chunk_btree(self, ds)
            patches.append((ds._btree_pos, struct.pack("<Q", root)))
        if os.fstat(self._fd).st_size < self._eof:
            os.ftruncate(self._fd, self._eof)
        os.pwrite(self._fd, struct.pack("<Q", self._eof), 40)
        for pos, data in patches:
            os.pwrite(self._fd, data, pos)
        for name in sorted(self._dirty, key=lambda n: n != "rf_data_index"):
            ds = self._dirty[name]
            os.pwrite(self._fd, struct.pack("<Q", ds.shape[0]), ds._dims_pos)
        self._dirty.clear()
        self._btree_dirty.clear()


def _write_chunk_btree(f: File, ds: Dataset) -> int:
    """Bulk-build a version-1 chunk B-tree over every allocated chunk of
    ``ds`` at the end of the file; returns the root node address."""
    cr, w = ds.chunks[0], ds.shape[1]
    esize = ds.storage_dtype.itemsize
    csize = cr * ds.row_bytes
    rows = sorted(ds.chunk_addrs)
    ksize = 8 + 8 * 3
    node_size = 24 + 2 * CHUNK_K * 8 + (2 * CHUNK_K + 1) * ksize

    def key(row, right=False):
        return struct.pack("<II3Q", csize, 0, row, w if right else 0,
                           esize if right else 0)

    # level 0: (left key, child) per chunk; the rightmost key bounds the
    # last chunk like the HDF5 library's own right-edge keys
    entries = [(key(r), ds.chunk_addrs[r][0]) for r in rows]
    right = key(rows[-1] + cr, right=True)
    level = 0
    while True:
        groups = [entries[i:i + 2 * CHUNK_K]
                  for i in range(0, len(entries), 2 * CHUNK_K)]
        addrs = [f._alloc(node_size) for _ in groups]
        for j, (grp, addr) in enumerate(zip(groups, addrs)):
            left_sib = addrs[j - 1] if j else UNDEF
            right_sib = addrs[j + 1] if j + 1 < len(addrs) else UNDEF
            last = groups[j + 1][0][0] if j + 1 < len(groups) else right
            body = b"".join(k + struct.pack("<Q", c) for k, c in grp) + last
            node = struct.pack("<4sBBHQQ", b"TREE", 1, level, len(grp),
                               left_sib, right_sib) + body
            os.pwrite(f._fd, node.ljust(node_size, b"\0"), addr)
        if len(addrs) == 1:
            return addrs[0]
        entries = [(grp[0][0], addr) for grp, addr in zip(groups, addrs)]
        level += 1


# ----------------------------------------------------------------- writer
class _Image:
    """A new file assembled in memory: bump allocation from offset 0."""

    def __init__(self):
        self.buf = bytearray()

    def alloc(self, n: int) -> int:
        addr = _pad8(len(self.buf))
        self.buf.extend(b"\0" * (addr + n - len(self.buf)))
        return addr

    def put(self, addr: int, data: bytes) -> None:
        self.buf[addr:addr + len(data)] = data


def _header_bytes(msgs: List[Tuple[int, bytes]]) -> bytes:
    body = b""
    for mtype, data in msgs:
        data = data.ljust(_pad8(len(data)), b"\0")
        body += struct.pack("<HHB3x", mtype, len(data), 0) + data
    return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body


def _attr_message(name: str, value) -> bytes:
    if isinstance(value, str):
        arr = np.array(value.encode() or b"\0")
    else:
        arr = np.asarray(value)
        if arr.dtype == bool:
            arr = arr.astype(np.int64)
    if arr.ndim:
        raise ValueError(f"attribute {name}: only scalars are written")
    dt = _encode_dtype(arr.dtype.newbyteorder("<") if arr.dtype.kind in "iuf"
                       else arr.dtype)
    sp = _encode_dataspace(())
    nm = name.encode() + b"\0"
    return (struct.pack("<BxHHH", 1, len(nm), len(dt), len(sp))
            + nm.ljust(_pad8(len(nm)), b"\0") + dt.ljust(_pad8(len(dt)), b"\0")
            + sp.ljust(_pad8(len(sp)), b"\0")
            + arr.astype(arr.dtype.newbyteorder("<")).tobytes())


def create(path, attrs: Optional[dict] = None,
           datasets: Tuple[Tuple[str, np.dtype, int, int], ...] = ()) -> None:
    """Write a new file: root attributes ``attrs`` (scalar ints, floats,
    bools, strings) and empty resizable datasets given as (name, dtype,
    ncols, chunk_rows). The file appears atomically (temp file + rename),
    so a polling reader never sees it half-written."""
    img = _Image()
    img.alloc(96)                                        # superblock
    names = sorted(n for n, *_ in datasets)
    heap_data = b"\0".ljust(8, b"\0")
    name_off = {}
    for n in names:
        name_off[n] = len(heap_data)
        nb = n.encode() + b"\0"
        heap_data += nb.ljust(_pad8(len(nb)), b"\0")
    heap = img.alloc(32 + len(heap_data))
    # free-list head 1 is the library's on-disk "no free block" marker
    img.put(heap, struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap_data), 1,
                              heap + 32) + heap_data)
    gnode_size = 24 + 2 * GROUP_INTERNAL_K * 8 + (2 * GROUP_INTERNAL_K + 1) * 8
    gtree = img.alloc(gnode_size)
    if len(names) > 2 * GROUP_LEAF_K:
        raise ValueError("too many datasets for one symbol node")
    entries = []
    for name, dt, ncols, chunk_rows in sorted(datasets, key=lambda d: d[0]):
        dt = np.dtype(dt)
        msgs = [
            (_MSG_DATASPACE, _encode_dataspace((0, ncols), (UNLIMITED, ncols))),
            (_MSG_DATATYPE, _encode_dtype(dt)),
            # fill value v2: late allocation, fill on allocation, undefined
            # (reads of unallocated chunks give zeros)
            (_MSG_FILL, struct.pack("<BBBB", 2, 2, 0, 0)),
            (_MSG_LAYOUT, struct.pack("<BBBQ3I", 3, 2, 3, UNDEF, chunk_rows,
                                      ncols, dt.itemsize)),
        ]
        hb = _header_bytes(msgs)
        addr = img.alloc(len(hb))
        img.put(addr, hb)
        entries.append((name_off[name], addr))
    if entries:
        snod_size = 8 + 2 * GROUP_LEAF_K * 40
        snod = img.alloc(snod_size)
        img.put(snod, struct.pack("<4sBxH", b"SNOD", 1, len(entries)) + b"".join(
            struct.pack("<QQI4x16x", off, addr, 0) for off, addr in entries))
        img.put(gtree, struct.pack("<4sBBHQQQQQ", b"TREE", 0, 0, 1, UNDEF,
                                   UNDEF, 0, snod, entries[-1][0]))
    else:
        img.put(gtree, struct.pack("<4sBBHQQQ", b"TREE", 0, 0, 0, UNDEF,
                                   UNDEF, 0))
    root_msgs = [(_MSG_SYMBOL_TABLE, struct.pack("<QQ", gtree, heap))]
    root_msgs += [(_MSG_ATTRIBUTE, _attr_message(k, v))
                  for k, v in (attrs or {}).items()]
    hb = _header_bytes(root_msgs)
    root = img.alloc(len(hb))
    img.put(root, hb)
    eof = _pad8(len(img.buf))
    img.alloc(eof - len(img.buf))
    img.put(0, SIGNATURE + struct.pack(
        "<BBBBBBBBHHI4Q", 0, 0, 0, 0, 0, 8, 8, 0, GROUP_LEAF_K,
        GROUP_INTERNAL_K, 0, 0, UNDEF, eof, UNDEF)
        + struct.pack("<QQI4xQQ", 0, root, 1, gtree, heap))
    path = Path(path)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as fh:
        fh.write(img.buf)
    os.replace(tmp, path)


def open_file(path):
    """Read-only handle on ``path``: this module's reader, or h5py for
    valid HDF5 outside the subset (compressed upstream captures). Raises
    :class:`Unsupported` when such a file meets an install without h5py."""
    try:
        f = File(path)
        for name in ("rf_data", "rf_data_index"):
            if name in f and not f[name].readable():
                f.close()
                raise Unsupported(f"{path}: {name} is filtered or split")
        return f
    except Unsupported as exc:
        try:
            import h5py
        except ImportError:
            raise Unsupported(f"{exc}; install h5py to read this file") from None
        return h5py.File(path, "r")
