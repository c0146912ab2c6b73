"""Multi-device STI via shard_map over a (time, chan) mesh.

Sharding layout (SURVEY.md section 2.3):
* sample buffer:  plane-major (nsub*2, nsamp), sharded over ``chan`` rows
  (r/i plane pairs stay on one device: nsub must divide by the chan-axis
  size); replicated over ``time`` for arbitrary frame starts, but sharded
  over ``time`` too when the block is packed contiguously
  (``contiguous=True`` — each device stores only its own column span);
* frame starts:   sharded over ``time`` — each device computes a disjoint
  block of STI columns (independent frame starts,
  reference: drfProc.py:159);
* sxx output:     sharded over (time, chan) — columns never leave their
  device unless the client asks for the assembled array;
* median PSD:     needs all columns per frequency bin, so the linear powers
  are all-gathered along ``time`` and reduced locally
  (replicated over time, sharded over chan).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyspectrogram_tpu.ops.stft import (
    median_over_time,
    median_over_time_psum,
    to_dbfs,
)
from pyspectrogram_tpu.ops.windows import WindowSpec, get_window
from pyspectrogram_tpu.parallel.mesh import CHAN_AXIS, TIME_AXIS

#: gathered-median budget: below this many bytes for the FULL gathered
#: power cube (ntime x nsub_l x nfft f32, replicated per device), the
#: time median all-gathers once and runs the single-device selection
#: locally; above it, the 33-round psum'd bisection keeps every device at
#: its own shard — at the reference's ntime = 1e5 ceiling with
#: nfft = 4096 the gathered cube is ~1.6 GB per device, which thrashes
#: or OOMs exactly at the scale the sharded tier exists to serve.
GATHERED_MEDIAN_MAX_BYTES = 256 * 1024 * 1024


def make_local_sti(
    *,
    nfft: int,
    nint: int = 1,
    mode: str = "welch",
    window: WindowSpec = ("kaiser", 1.7),
    ref: float = 1.0,
    fft_impl: str = "auto",
):
    """The per-shard STI body shared by every shard_map tier: plane-major
    samples + frame starts -> LINEAR fftshifted power (ntime_l, nsub_l,
    nfft). Raw integer planes widen here, per shard on device; the body
    is the single-chip program's (ops.stft.make_xla_psd)."""
    from pyspectrogram_tpu.ops.stft import check_fft_impl, make_xla_psd

    check_fft_impl(fft_impl)
    get_window(window, nfft)  # validate the spec eagerly
    xla_psd = make_xla_psd(nfft=nfft, nint=nint, mode=mode, window=window,
                           ref=ref)

    def local_sti(samples_pm, starts):
        return xla_psd(samples_pm.astype(jnp.float32), starts)

    return local_sti


def make_sharded_sti_fn(mesh: Mesh, *, tile=None, **kw):
    """Jitted multi-device STI — see :func:`_make_sharded_sti_fn` for the
    full contract. This uncached wrapper canonicalizes the display tile's
    color range (``TileSpec.crop_key``) BEFORE the compile cache, so specs
    differing only in cmin/cmax hit the same compiled program whether or
    not the caller remembered to pass ``spec.crop_key()`` — a re-clim
    must never cost a recompile (same two-level pattern as
    ops.stft.make_sti_fn_pm)."""
    return _make_sharded_sti_fn(
        mesh, tile=tile.crop_key() if tile is not None else None, **kw)


@functools.lru_cache(maxsize=64)
def _make_sharded_sti_fn(
    mesh: Mesh,
    *,
    nfft: int,
    nint: int = 1,
    ntime_valid: int,
    mode: str = "welch",
    window: WindowSpec = ("kaiser", 1.7),
    ref: float = 1.0,
    eps: float = 1e-15,
    fft_impl: str = "auto",
    contiguous: bool = False,
    tile=None,
):
    """Jitted multi-device STI.

    Returned ``f(samples_pm, starts)`` (``f(samples_pm, starts, qparams)``
    when ``tile`` is set):
      samples_pm: (nsub*2, nsamp) float32 plane-major — nsub divisible by
                  the chan-axis size;
      starts:     (ntime_padded,) int32 — divisible by the time-axis size;
                  only the first ``ntime_valid`` columns count for the
                  median.
    Returns {"sxx_dbfs": (ntime_padded, nsub, nfft) sharded (time, chan),
             "sxx_med_dbfs": (nsub, nfft) sharded (chan,)}.

    ``contiguous=True`` asserts the PACKED layout (column t's frame at
    t*frame_len — what models.sti.assemble_device_block produces, padded
    via mesh.pad_contiguous_block). The sample buffer then shards over
    BOTH mesh axes — each device stores only its own column span instead
    of a full replica per time-axis row — with starts rebased to the
    shard base in-shard. The gathered
    default keeps replication because arbitrary starts may read anywhere
    in the buffer (pad_starts' repeated-last-start columns included).

    ``tile`` (a display.TileSpec — pass ``spec.crop_key()`` so compiled
    programs key only on the crop plan) fuses the display epilogue into
    the sharded program: each device crops, decimates, and quantizes ITS
    OWN columns to uint8 before anything leaves the shard, with the color
    range riding in as the ``qparams`` runtime operand (a re-clim re-runs
    the same program). The float spectra are then dropped on device —
    the return carries ``"tile"`` instead of ``"sxx_dbfs"`` — matching
    the single-chip fused program's contract (ops.stft.make_sti_fn_pm).
    """
    local_sti = make_local_sti(nfft=nfft, nint=nint, mode=mode,
                               window=window, ref=ref, fft_impl=fft_impl)

    def sharded(samples_pm, starts, qparams=None):
        if contiguous:
            # global ladder starts (t*frame_len) -> this shard's local
            # ladder; the shard's buffer begins at its first column
            starts = starts - starts[0]
        p_local = local_sti(samples_pm, starts)
        ndev_t = mesh.shape[TIME_AXIS]
        cube = p_local.shape[0] * ndev_t * np.prod(p_local.shape[1:]) * 4
        if cube <= GATHERED_MEDIAN_MAX_BYTES:
            # gather all columns of my channel shard for the time median
            # (one all-gather, then the single-device selection)
            p_all = jax.lax.all_gather(p_local, TIME_AXIS, axis=0,
                                       tiled=True)
            p_med = median_over_time(p_all, ntime_valid)  # (nsub_l, nfft)
        else:
            # huge ntime: psum'd bisection — no device ever holds more
            # than its shard (see GATHERED_MEDIAN_MAX_BYTES)
            p_med = median_over_time_psum(p_local, TIME_AXIS, ntime_valid)
        out = {"sxx_med_dbfs": to_dbfs(p_med, eps)}
        if tile is not None:
            from pyspectrogram_tpu.display.tile import quantize_tile_linear

            out["tile"] = quantize_tile_linear(p_local, tile, eps, qparams)
        else:
            out["sxx_dbfs"] = to_dbfs(p_local, eps)
        return out

    samples_spec = (
        P(CHAN_AXIS, TIME_AXIS) if contiguous else P(CHAN_AXIS, None)
    )
    in_specs = (samples_spec, P(TIME_AXIS))
    out_specs = {"sxx_med_dbfs": P(CHAN_AXIS, None)}
    if tile is not None:
        in_specs = in_specs + (P(None),)  # qparams: replicated (2,)
        out_specs["tile"] = P(TIME_AXIS, CHAN_AXIS, None)
    else:
        out_specs["sxx_dbfs"] = P(TIME_AXIS, CHAN_AXIS, None)
    jitted = jax.jit(shard_map(sharded, mesh=mesh, in_specs=in_specs,
                               out_specs=out_specs, check_vma=False))

    if tile is not None:
        # the factory caches on the canonicalized crop plan (crop_key),
        # whose own qparams are a meaningless placeholder — so unlike the
        # single-chip program there is no usable default, and omitting
        # the operand would otherwise die in an opaque shard_map pytree
        # mismatch instead of naming the contract (cf. big_sti's guard)
        def fn(samples_pm, starts, qparams=None):
            if qparams is None:
                raise ValueError(
                    "tile mode requires the color-range operand: call "
                    "fn(samples_pm, starts, spec.qparams)")
            return jitted(samples_pm, starts, qparams)
    else:
        fn = jitted

    fn.input_shardings = lambda: tuple(
        NamedSharding(mesh, s) for s in in_specs
    )
    return fn
