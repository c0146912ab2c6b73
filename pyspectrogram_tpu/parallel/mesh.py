"""Device-mesh construction for multi-chip STI computation.

The reference has no parallelism beyond 7 Qt worker threads in one process
(reference: drfview.py:177-178); SURVEY.md section 2.3 maps the strategies.
Here scaling is expressed over a 2-D ``jax.sharding.Mesh``:

* ``time``  — sequence/context parallel axis: STI columns have independent
  frame starts (reference: drfProc.py:159), so columns shard embarrassingly;
* ``chan``  — batch axis over subchannels/channels (each device FFTs its
  channel slice; no cross-device math).

Collectives (an all-gather of column shards for the time-median PSD) ride
the device interconnect (NVLink between cards) via XLA; no host message
passing is involved.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

TIME_AXIS = "time"
CHAN_AXIS = "chan"


def make_mesh(
    devices: Optional[Sequence] = None,
    time_parallel: Optional[int] = None,
    chan_parallel: Optional[int] = None,
) -> Mesh:
    """2-D (time, chan) mesh over the given (default: all) devices.

    With no explicit split, devices go to the time axis — STI columns are
    the most abundant parallel work (ntime up to 1e5,
    reference: drfview.py:501).
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if time_parallel is None and chan_parallel is None:
        time_parallel, chan_parallel = n, 1
    elif time_parallel is None:
        time_parallel = n // chan_parallel
    elif chan_parallel is None:
        chan_parallel = n // time_parallel
    if time_parallel * chan_parallel != n:
        raise ValueError(
            f"mesh {time_parallel}x{chan_parallel} != {n} devices"
        )
    arr = np.asarray(devices).reshape(time_parallel, chan_parallel)
    return Mesh(arr, (TIME_AXIS, CHAN_AXIS))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_starts(starts: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Pad frame starts to a multiple of the time-axis size by repeating the
    last start; returns (padded, original_len). Padded columns recompute the
    final column and are dropped on the host — cheap and shape-static."""
    n = len(starts)
    target = pad_to_multiple(n, multiple)
    if target == n:
        return starts, n
    pad = np.full(target - n, starts[-1], dtype=starts.dtype)
    return np.concatenate([starts, pad]), n


def pad_contiguous_block(
    samples_pm: np.ndarray, ntime: int, frame_len: int, multiple: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad a PACKED contiguous frame block (column t's frame at
    t*frame_len — the layout models.sti.assemble_device_block always
    produces) to a column count divisible by the time-axis size.

    Unlike :func:`pad_starts` (which repeats the last start and therefore
    needs the sample buffer replicated across the time axis so every
    device can reach it), the padded columns here EXTEND the ladder into
    appended zero samples, keeping column t's frame at t*frame_len
    everywhere — so the buffer itself shards over ``time``: each device
    stores and receives only its own span (1/time_axis of the bytes) and
    keeps the contiguous ladder layout.

    Returns (samples_padded, starts_padded, original_ntime); padded
    columns are excluded from the median via ntime_valid and dropped on
    the host.
    """
    target = pad_to_multiple(ntime, multiple)
    starts = np.arange(target, dtype=np.int32) * frame_len
    if target != ntime:
        pad = np.zeros(
            (samples_pm.shape[0], (target - ntime) * frame_len),
            samples_pm.dtype,
        )
        samples_pm = np.concatenate([samples_pm, pad], axis=1)
    return samples_pm, starts, ntime
