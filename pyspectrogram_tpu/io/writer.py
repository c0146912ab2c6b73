"""Digital RF channel writer.

The reference has no writer (it only views data produced by external
recorders); a writer is required here both to generate synthetic test
fixtures (SURVEY.md section 4.3) and to make the framework a complete,
standalone Digital RF toolchain. Output is format-compatible with the
upstream ``digital_rf`` library and with this package's reader.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from pyspectrogram_tpu.io import drf_format as fmt
from pyspectrogram_tpu.io import h5lite
from pyspectrogram_tpu.utils.errors import FormatError

#: rows per rf_data_index chunk (one 1 KiB chunk holds 64 runs)
INDEX_CHUNK_ROWS = 64


class DigitalRFWriter:
    """Append-only writer for one channel.

    Samples are addressed by absolute index since the epoch at the channel's
    rational rate. ``rf_write`` appends contiguous data; ``skip`` advances
    the write head, producing a gap (recorded via ``rf_data_index``).
    """

    def __init__(
        self,
        top_dir: Union[str, Path],
        channel: str,
        dtype,
        start_global_index: int,
        sample_rate_numerator: int,
        sample_rate_denominator: int = 1,
        subdir_cadence_secs: int = 3600,
        file_cadence_millisecs: int = 1000,
        num_subchannels: int = 1,
    ):
        self.top_dir = Path(top_dir)
        self.channel = channel
        self.user_dtype = np.dtype(dtype)
        self.disk_dtype = fmt.storage_dtype(self.user_dtype)
        klass, size, prec, is_complex = fmt.base_dtype_properties(self.user_dtype)
        self.props = fmt.ChannelProperties(
            sample_rate_numerator=sample_rate_numerator,
            sample_rate_denominator=sample_rate_denominator,
            subdir_cadence_secs=subdir_cadence_secs,
            file_cadence_millisecs=file_cadence_millisecs,
            num_subchannels=num_subchannels,
            is_complex=is_complex,
            is_continuous=True,
            h5_class=klass,
            h5_size=size,
            h5_precision=prec,
        )
        self.next_index = int(start_global_index)
        self._gap_pending = False
        chan_dir = self.top_dir / channel
        chan_dir.mkdir(parents=True, exist_ok=True)
        fmt.write_properties(chan_dir / fmt.PROPERTIES_FILENAME, self.props)

    # ------------------------------------------------------------------
    def rf_write(self, arr: np.ndarray, global_index: Optional[int] = None) -> int:
        """Append a contiguous block; returns the next write index.

        ``arr`` is (n,) or (n, num_subchannels); ``global_index`` (if given)
        must be >= the current head and creates a gap when greater.
        """
        arr = np.asarray(arr)
        if arr.ndim == 1:
            arr = arr[:, None]
        if arr.ndim != 2 or arr.shape[1] != self.props.num_subchannels:
            raise FormatError(
                f"expected (n, {self.props.num_subchannels}) data, got {arr.shape}"
            )
        if global_index is not None:
            gi = int(global_index)
            if gi < self.next_index:
                raise FormatError("rf_write indices must be monotonically increasing")
            if gi > self.next_index:
                self._gap_pending = True
            self.next_index = gi
        if arr.dtype != self.user_dtype:
            arr = arr.astype(self.user_dtype)
        disk = fmt.packed_view(arr)

        start = self.next_index
        end = start + len(arr)
        s = start
        ms = self.props.file_start_ms(s)
        while s < end:
            _, span_end = self.props.file_sample_span(ms)
            chunk_end = min(end, span_end)
            if chunk_end > s:
                self._append_to_file(ms, s, disk[s - start : chunk_end - start])
                s = chunk_end
            # a cadence window holding zero samples (rate below
            # 1000/file_cadence_millisecs) writes no file at all —
            # appending here would litter empty .h5 files with bogus
            # zero-row index entries
            ms += self.props.file_cadence_millisecs
        self.next_index = end
        self._gap_pending = False
        return self.next_index

    def skip(self, n_samples: int) -> None:
        """Advance the write head without writing (creates a data gap)."""
        if n_samples < 0:
            raise FormatError("cannot skip backwards")
        self.next_index += int(n_samples)
        self._gap_pending = True

    # ------------------------------------------------------------------
    def _append_to_file(self, file_ms: int, global_start: int, disk_rows) -> None:
        path = self.props.file_path(self.top_dir, self.channel, file_ms)
        path.parent.mkdir(parents=True, exist_ok=True)
        if not path.exists():
            # full-row-width chunks: each chunk is then a contiguous byte
            # range of whole sample rows, which the pooled GIL-free read
            # path (io.fastread) maps directly. The chunk row count is
            # bounded (NOT the whole file span): uncompressed chunks are
            # allocated full-size, so a file holding a few rows of a
            # sparse capture would otherwise occupy chunk_rows*row_bytes
            # on disk regardless of data written. 8192 rows bounds that
            # overallocation while the fastread extent map merges
            # byte-adjacent chunks back into single preadv extents.
            span = self.props.file_sample_span(file_ms)
            chunk_rows = max(1, min(int(span[1] - span[0]), 8192))
            h5lite.create(path, datasets=(
                ("rf_data", self.disk_dtype, self.props.num_subchannels,
                 chunk_rows),
                ("rf_data_index", np.dtype("<u8"), 2, INDEX_CHUNK_ROWS),
            ))
        with h5lite.File(path, "a") as f:
            ds = f["rf_data"]
            idx = f["rf_data_index"]
            row = ds.shape[0]
            # New index entry at file start or after a gap; otherwise the
            # block continues the previous contiguous run.
            need_entry = True
            if idx.shape[0] and not self._gap_pending:
                last_g, last_r = (int(v) for v in idx[-1])
                if last_g + (row - last_r) == global_start:
                    need_entry = False
            f.append("rf_data", disk_rows)
            if need_entry:
                f.append("rf_data_index",
                         np.array([[global_start, row]], np.uint64))

    def close(self) -> None:  # API symmetry; files are closed per-append
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
