"""STI/PSD compute core (JAX/XLA).

This replaces the reference's compute chain — per-column reads, Kaiser
window, scipy periodogram, fftshift, median, dB (reference:
drfProc.py:300-310, drfProc.py:364-403) — with one jitted device program:

    strided frame gather -> window multiply -> batched complex FFT ->
    |X|^2 -> (Welch average) -> fftshift -> dB ; median PSD across time

Design choices (see SURVEY.md section 7):
* Static shapes everywhere: (ntime, nsub, nfft) with the FFT axis last, so
  the batched FFT (cuFFT on the GPU) runs over contiguous rows and XLA
  fuses the elementwise work around it.
* dBFS normalization (x / full_scale_ref, reference: drfProc.py:129) is
  folded into the power scale (1/(ref^2 * win_sum^2)) — raw integer samples
  can be shipped to HBM unconverted (half the transfer bytes) and
  normalized for free.
* "parity" mode gathers only nfft samples per column, reproducing the
  reference's verified truncation semantics (scipy periodogram crops to the
  first nfft samples when nint > 1; reference: drfProc.py:387-396);
  "welch" gathers nfft*nint and truly averages nint segment powers.
* The FFT implementation is pluggable (`fft_impl`): "xla" uses the XLA FFT
  (cuFFT on the GPU); "gemm" the factorized DFT-as-matmul of
  kernels.gemm_fft.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pyspectrogram_tpu.ops.windows import WindowSpec, get_window


def pack_complex_host(x: np.ndarray) -> np.ndarray:
    """complex (..., ) host array -> real (..., 2) plane-packed view (zero copy).

    The canonical host->device representation: packed planes halve
    transfer bytes for raw integer captures, and a complex64 array's
    memory IS (float32, float32) pairs — so this is free.
    """
    x = np.ascontiguousarray(x)
    if x.dtype.kind != "c":
        raise ValueError(f"expected complex array, got {x.dtype}")
    real = np.dtype(f"f{x.dtype.itemsize // 2}")
    return x.view(real).reshape(x.shape + (2,))


def gather_frames(samples: jax.Array, starts: jax.Array, frame_len: int) -> jax.Array:
    """Gather strided frames from a sample buffer.

    samples: (nsamp, nsub[, 2]) — trailing 2 = packed real/imag planes.
    starts:  (ntime,) int32 frame-start offsets (relative to buffer start).
    Returns (ntime, nsub, frame_len[, 2]).

    Equivalent of the reference's per-column HDF5 read loop
    (reference: drfProc.py:159-166), done on-device from a resident buffer.
    """
    # slice whole rows instead of a generic element gather (take with a
    # 2-D index matrix): view trailing dims as one minor axis and vmap a
    # dynamic_slice over the frame starts, which XLA lowers to contiguous
    # block copies
    trailing = samples.shape[1:]
    ncol = int(np.prod(trailing)) if trailing else 1
    flat = samples.reshape(samples.shape[0], ncol)

    def one(s):
        return jax.lax.dynamic_slice(flat, (s, 0), (frame_len, ncol))

    frames = jax.vmap(one)(starts)                   # (ntime, frame_len, ncol)
    frames = frames.reshape((starts.shape[0], frame_len) + trailing)
    return jnp.moveaxis(frames, 1, 2) if trailing else frames[:, None, :]


def _to_complex(frames: jax.Array, real_dtype) -> jax.Array:
    """(..., 2) packed real/imag planes or complex array -> complex."""
    if jnp.issubdtype(frames.dtype, jnp.complexfloating):
        return frames
    if frames.shape[-1] != 2:
        raise ValueError(
            "real-valued sample buffers must pack planes as (..., 2); got "
            f"shape {frames.shape} dtype {frames.dtype}"
        )
    return jax.lax.complex(
        frames[..., 0].astype(real_dtype), frames[..., 1].astype(real_dtype)
    )


def psd_frames(
    frames: jax.Array,
    window: jax.Array,
    power_scale: float,
    fft_fn=jnp.fft.fft,
) -> jax.Array:
    """Windowed two-sided 'spectrum'-scaled periodogram of (..., nfft)
    complex frames."""
    real_dtype = jnp.float64 if frames.dtype == jnp.complex128 else jnp.float32
    xw = frames * window.astype(real_dtype)
    X = fft_fn(xw)
    return (jnp.real(X) ** 2 + jnp.imag(X) ** 2) * jnp.asarray(
        power_scale, real_dtype
    )


@functools.lru_cache(maxsize=256)
def make_sti_fn(
    *,
    nfft: int,
    nint: int = 1,
    mode: str = "welch",
    window: WindowSpec = ("kaiser", 1.7),
    ref: float = 1.0,
    eps: float = 1e-15,
    fft_impl: str = "xla",
    return_linear: bool = False,
    compute_dtype=jnp.complex64,
):
    """Build a jitted STI function for fixed (nfft, nint, mode, window).

    The returned function has signature ``f(samples, starts)`` with
      samples: (nsamp, nsub) complex — or (nsamp, nsub, 2) packed
               real/imag planes in any real dtype (e.g. raw int16);
      starts:  (ntime,) int32 frame starts relative to the buffer;
    and returns a dict with
      sxx_dbfs:     (ntime, nsub, nfft)  fftshifted STI in dBFS;
      sxx_med_dbfs: (nsub, nfft)         median-over-time PSD in dBFS;
      (+ sxx, sxx_med linear power when ``return_linear``).

    Output layout is time-major; use
    :func:`to_reference_layout` for the reference's (nfft, ntime, nsub).
    """
    win64 = get_window(window, nfft)  # float64 on host
    inv_scale = 1.0 / (float(win64.sum()) ** 2 * float(ref) ** 2)
    frame_len = nfft * nint if mode == "welch" else nfft
    if mode not in ("parity", "welch"):
        raise ValueError(f"mode must be 'parity' or 'welch', got {mode!r}")

    if fft_impl == "xla":
        fft_fn = jnp.fft.fft
    elif fft_impl == "gemm":
        from pyspectrogram_tpu.kernels.gemm_fft import make_gemm_fft
        fft_fn = make_gemm_fft(nfft)
    else:
        raise ValueError(f"unknown fft_impl {fft_impl!r}")

    real_dtype = jnp.float64 if compute_dtype == jnp.complex128 else jnp.float32
    win = win64.astype(real_dtype)

    @jax.jit
    def sti_fn(samples: jax.Array, starts: jax.Array) -> dict:
        frames = gather_frames(samples, starts, frame_len)
        x = _to_complex(frames, real_dtype).astype(compute_dtype)
        if mode == "welch":
            x = x.reshape(x.shape[0], x.shape[1], nint, nfft)
            p = psd_frames(x, win, inv_scale, fft_fn).mean(axis=2)
        else:
            p = psd_frames(x, win, inv_scale, fft_fn)
        p = jnp.fft.fftshift(p, axes=-1)              # (ntime, nsub, nfft)
        p_med = median_over_time(p)                   # (nsub, nfft)
        out = {
            "sxx_dbfs": to_dbfs(p, eps),
            "sxx_med_dbfs": to_dbfs(p_med, eps),
        }
        if return_linear:
            out["sxx"] = p
            out["sxx_med"] = p_med
        return out

    return sti_fn


def _float_order_key(x: jax.Array) -> jax.Array:
    """float32 -> int32 key with the same total order (sign-magnitude to
    two's-complement flip; an involution)."""
    b = jax.lax.bitcast_convert_type(x, jnp.int32)
    return b ^ (jax.lax.shift_right_arithmetic(b, 31) & jnp.int32(0x7FFFFFFF))


def _kth_smallest_f32(x: jax.Array, k: int) -> jax.Array:
    """Exact k-th smallest (1-indexed) along axis 0 via 33-step bisection
    on the float bit pattern — O(33·n) fully-vectorized compare+count, no
    sort HLO. Exact for all normal floats (platforms that flush denormals
    may differ below ~1e-38, i.e. under -750 dBFS).

    Each step re-reads the buffer: 33 passes over the (n, ..., nfft)
    power cube unless XLA keeps it in cache. A single-read selection
    (one bin tile held on chip) is the kernel to write if a trace shows
    this term."""
    kb = _float_order_key(x)
    lo = jnp.full(x.shape[1:], jnp.int32(-0x7F800001), jnp.int32)
    hi = jnp.full(x.shape[1:], jnp.int32(0x7F800000), jnp.int32)

    def body(_, lh):
        lo, hi = lh
        # overflow-free floor((lo+hi)/2): the bracket spans > int32 range
        mid = (lo & hi) + jax.lax.shift_right_arithmetic(lo ^ hi, 1)
        cnt = (kb <= mid[None]).sum(axis=0)
        go_hi = cnt >= k
        return (jnp.where(go_hi, lo, mid + 1), jnp.where(go_hi, mid, hi))

    # 33 halvings shrink the full key span (~2^32) to 0, guaranteeing
    # lo == hi == the answer's key (32 would leave a 1-wide bracket).
    lo, hi = jax.lax.fori_loop(0, 33, body, (lo, hi))
    key = hi ^ (jax.lax.shift_right_arithmetic(hi, 31) & jnp.int32(0x7FFFFFFF))
    return jax.lax.bitcast_convert_type(key, jnp.float32)


@functools.lru_cache(maxsize=64)
def _batcher_pairs(n: int):
    """Compare-exchange pairs of Batcher's odd-even mergesort for n rows
    (host-side plan; ~n log^2 n / 4 pairs)."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


#: below this many rows the sorting-network median beats the 33-pass
#: bisection (network: ~n log^2 n / 2 row ops vs bisection: 33 n row
#: reads — at n = 8 that is ~38 vs ~264, and at nfft = 2^20 the median
#: dominates the whole STI step)
MEDIAN_NETWORK_MAX_N = 32


def _median_network(p: jax.Array, n: int) -> jax.Array:
    rows = [p[i] for i in range(n)]
    for a, b in _batcher_pairs(n):
        lo = jnp.minimum(rows[a], rows[b])
        hi = jnp.maximum(rows[a], rows[b])
        rows[a], rows[b] = lo, hi
    if n % 2:
        return rows[n // 2]
    return 0.5 * (rows[n // 2 - 1] + rows[n // 2])


def median_over_time(p: jax.Array, ntime_valid: Optional[int] = None
                     ) -> jax.Array:
    """Median across the leading (time) axis of (ntime, ..., nfft)
    (the reference's per-subchannel median PSD, drfProc.py:401).

    Selection without a sort HLO, two tiers:

    * small ntime (<= 32): Batcher odd-even merge network of vectorized
      min/max over whole rows — exact sort, ~7x less memory traffic than
      bisection at n = 8 (this bounds giant-nfft STI steps, where the
      median dominates);
    * larger ntime: 33-step bisection on float bit patterns — pure
      compare/count vector work, O(33 n) row reads independent of n's
      log factor. Matches numpy median exactly for float32 (see
      _kth_smallest_f32); float64 falls back to a minor-axis sort
      (host/oracle paths only).

    ``ntime_valid`` restricts to a leading prefix (used when the time axis
    is padded for sharding).
    """
    n = p.shape[0] if ntime_valid is None else ntime_valid
    p = p[:n]
    if n <= MEDIAN_NETWORK_MAX_N:
        return _median_network(p, n)
    if p.dtype != jnp.float32:
        q = jnp.moveaxis(p, 0, -1)
        s = jnp.sort(q, axis=-1)
        if n % 2:
            return s[..., n // 2]
        return 0.5 * (s[..., n // 2 - 1] + s[..., n // 2])
    k = (n + 1) // 2
    v1 = _kth_smallest_f32(p, k)
    if n % 2:
        return v1
    cnt_le = (p <= v1[None]).sum(axis=0)
    bigger = jnp.where(p > v1[None], p, jnp.inf)
    v2 = jnp.where(cnt_le > k, v1, bigger.min(axis=0))
    return 0.5 * (v1 + v2)


def median_over_time_psum(p: jax.Array, axis_name: str,
                          ntime_valid: Optional[int] = None,
                          row_window: Optional[tuple] = None) -> jax.Array:
    """Median across a time axis SHARDED over ``axis_name`` — call inside
    shard_map with ``p`` = this device's (ntime_l, ..., nfft) float32
    shard of the row-sharded buffer.

    The same 33-step float-bit bisection as :func:`_kth_smallest_f32`,
    but each round's compare-count is summed over the mesh axis
    (``lax.psum`` of one (..., nfft) int32 plane), so NO device ever
    holds more than its own shard: the all-gather alternative replicates
    the full ntime x ... x nfft power cube onto every device — ~1.6 GB
    at the reference's documented ntime = 1e5 ceiling with nfft = 4096 —
    while 33 psum'd count planes move ~33 * nfft * 4 bytes per row of
    output. Rows at global index >= ``ntime_valid`` (time-axis padding)
    are masked out of every count; ``row_window=(lo, hi)`` instead
    restricts to an arbitrary global row range (the mesh-DP batch tier's
    per-request column spans). Exact for float32, matching
    :func:`median_over_time` (even-n mean of the two middles included).
    """
    ntime_l = p.shape[0]
    if row_window is None and ntime_valid is None:
        raise ValueError(
            "median_over_time_psum needs the global row span: pass "
            "ntime_valid (valid-prefix length) or row_window=(lo, hi) — "
            "the shard cannot see the global row count on its own")
    lo_r, hi_r = (0, int(ntime_valid)) if row_window is None else (
        int(row_window[0]), int(row_window[1]))
    n = hi_r - lo_r
    k = (n + 1) // 2
    idx = jax.lax.axis_index(axis_name) * ntime_l + jnp.arange(ntime_l)
    valid = ((idx >= lo_r) & (idx < hi_r)).reshape(
        (ntime_l,) + (1,) * (p.ndim - 1))
    kb = _float_order_key(p)
    lo = jnp.full(p.shape[1:], jnp.int32(-0x7F800001), jnp.int32)
    hi = jnp.full(p.shape[1:], jnp.int32(0x7F800000), jnp.int32)

    def body(_, lh):
        lo, hi = lh
        mid = (lo & hi) + jax.lax.shift_right_arithmetic(lo ^ hi, 1)
        cnt = jax.lax.psum(((kb <= mid[None]) & valid).sum(axis=0),
                           axis_name)
        go_hi = cnt >= k
        return (jnp.where(go_hi, lo, mid + 1), jnp.where(go_hi, mid, hi))

    lo, hi = jax.lax.fori_loop(0, 33, body, (lo, hi))
    key = hi ^ (jax.lax.shift_right_arithmetic(hi, 31) & jnp.int32(0x7FFFFFFF))
    v1 = jax.lax.bitcast_convert_type(key, jnp.float32)
    if n % 2:
        return v1
    cnt_le = jax.lax.psum(((p <= v1[None]) & valid).sum(axis=0), axis_name)
    bigger = jnp.where((p > v1[None]) & valid, p, jnp.inf)
    v2 = jnp.where(cnt_le > k, v1,
                   jax.lax.pmin(bigger.min(axis=0), axis_name))
    return 0.5 * (v1 + v2)


def to_dbfs(x: jax.Array, eps: float = 1e-15) -> jax.Array:
    """10*log10(x + eps) — the reference's dB conversion
    (reference: drfProc.py:308-310)."""
    return 10.0 * jnp.log10(x + jnp.asarray(eps, x.dtype))


def check_fft_impl(fft_impl: str) -> None:
    """The plane-major programs run one FFT path, the XLA one; "auto"
    names it too. Anything else is an error, never a silent fallback."""
    if fft_impl not in ("auto", "xla"):
        raise ValueError(
            f"unknown fft_impl {fft_impl!r}: the plane-major STI runs the "
            "XLA FFT ('auto' or 'xla')")


def make_xla_psd(
    *,
    nfft: int,
    nint: int = 1,
    mode: str = "welch",
    window: WindowSpec = ("kaiser", 1.7),
    ref: float = 1.0,
):
    """The gather+Welch XLA step body: plane-major samples + frame starts
    -> fftshifted LINEAR power (ntime, nsub, nfft). ONE implementation
    behind the single-chip program (_make_sti_fn_pm), every shard_map
    tier's body (parallel.sharded.make_local_sti) and the streaming core —
    a scaling or dtype fix lands once for all of them."""
    win64 = get_window(window, nfft)
    inv_scale = 1.0 / (float(win64.sum()) ** 2 * float(ref) ** 2)
    win = win64.astype(np.float32)
    frame_len = nfft * nint if mode == "welch" else nfft

    def xla_psd(samples_pm, starts):
        def one_start(s):
            return jax.vmap(
                lambda row: jax.lax.dynamic_slice(row, (s,), (frame_len,))
            )(samples_pm)

        fr = jax.vmap(one_start)(starts)       # (ntime, nsub*2, L)
        c = jax.lax.complex(fr[:, 0::2, :], fr[:, 1::2, :]).astype(
            jnp.complex64)
        if mode == "welch":
            c = c.reshape(c.shape[0], c.shape[1], nint, nfft)
            p = psd_frames(c, jnp.asarray(win), inv_scale).mean(axis=2)
        else:
            p = psd_frames(c, jnp.asarray(win), inv_scale)
        return jnp.fft.fftshift(p, axes=-1)

    return xla_psd


@functools.lru_cache(maxsize=256)
def make_sti_fn_pm(
    *,
    nfft: int,
    nint: int = 1,
    mode: str = "welch",
    window: WindowSpec = ("kaiser", 1.7),
    ref: float = 1.0,
    eps: float = 1e-15,
    fft_impl: str = "auto",
    return_linear: bool = False,
    return_minmax: bool = False,
    contiguous: bool = False,
    precision: str = "exact",
    tile=None,
):
    """Plane-major STI factory — the production device entry point.

    ``contiguous`` (column t's frame starts at t*nfft*nint) and
    ``precision`` are accepted for API and checkpoint compatibility; the
    program is the same exact-float32 XLA body whatever they say
    (``precision`` selects GEMM tiers only in parallel.big_sti).

    With ``tile`` set, the COMPILED program keys on the tile's crop plan
    only (``TileSpec.crop_key``): the color range rides in as a runtime
    (2,) operand, so specs differing only in cmin/cmax share one device
    program (a color-range tweak in a live view must not recompile).
    The returned fn optionally takes that
    operand: ``f(samples_pm, starts, qparams=None)`` with qparams from
    ``TileSpec.qparams`` (defaults to the factory tile's own range).
    """
    # contiguous and precision do not change the compiled program (see
    # _make_sti_fn_pm): they stay out of its cache key
    del contiguous, precision
    if tile is None:
        return _make_sti_fn_pm(
            nfft=nfft, nint=nint, mode=mode, window=window, ref=ref,
            eps=eps, fft_impl=fft_impl, return_linear=return_linear,
            return_minmax=return_minmax, tile=None,
        )
    inner = _make_sti_fn_pm(
        nfft=nfft, nint=nint, mode=mode, window=window, ref=ref,
        eps=eps, fft_impl=fft_impl, return_linear=return_linear,
        return_minmax=return_minmax, tile=tile.crop_key(),
    )
    default_qp = tile.qparams

    def sti_fn(samples_pm, starts, qparams=None):
        qp = default_qp if qparams is None else np.asarray(
            qparams, np.float32)
        return inner(samples_pm, starts, qp)

    return sti_fn


@functools.lru_cache(maxsize=256)
def _make_sti_fn_pm(
    *,
    nfft: int,
    nint: int = 1,
    mode: str = "welch",
    window: WindowSpec = ("kaiser", 1.7),
    ref: float = 1.0,
    eps: float = 1e-15,
    fft_impl: str = "auto",
    return_linear: bool = False,
    return_minmax: bool = False,
    tile=None,
):
    """The compiled-program factory behind :func:`make_sti_fn_pm`.

    ``f(samples_pm, starts)`` with samples_pm (nsub*2, nsamp) float32
    (row 2s = subchannel s real plane, row 2s+1 = imag plane) or raw
    integer planes, and starts (ntime,) int32. Output layout matches
    :func:`make_sti_fn`.

    ``fft_impl``: "auto" or "xla" — both the plain XLA body
    (:func:`make_xla_psd`, cuFFT on the GPU); anything else raises.

    ``tile`` (a display.TileSpec) swaps ``out["sxx_dbfs"]`` for
    ``out["tile"]``: the display epilogue — frequency-window crop, fscale
    decimation, dB, clamp, uint8 level quantization — fused into the same
    device program (reference: drfview.py:1006-1023 + drfview.py:1057).
    The full float spectra are neither emitted nor converted to dB, so a
    display client reads back only the uint8 tile (same contract as the
    sharded tier, parallel.sharded).
    """
    check_fft_impl(fft_impl)
    xla_psd = make_xla_psd(nfft=nfft, nint=nint, mode=mode, window=window,
                           ref=ref)

    @jax.jit
    def sti_fn(samples_pm: jax.Array, starts: jax.Array,
               qparams=None) -> dict:
        # raw integer planes ship at half the bytes and widen once on
        # device (normalization rides the power scale)
        p = xla_psd(samples_pm.astype(jnp.float32), starts)
        p_med = median_over_time(p)
        out = {"sxx_med_dbfs": to_dbfs(p_med, eps)}
        if tile is not None:
            # display mode: the float spectra stay on device — emitting
            # sxx_dbfs too would pay a full log10 pass plus an
            # (ntime, nsub, nfft) f32 HBM output no tile client reads
            # (the sharded tier drops it the same way, parallel.sharded)
            from pyspectrogram_tpu.display.tile import quantize_tile_linear

            out["tile"] = quantize_tile_linear(p, tile, eps, qparams)
        else:
            out["sxx_dbfs"] = to_dbfs(p, eps)
        if return_minmax:
            # min/median/max summary spectra — the capability of the
            # reference's alternate proc_data path (drfProc.py:406-453)
            out["sxx_min_dbfs"] = to_dbfs(p.min(axis=0), eps)
            out["sxx_max_dbfs"] = to_dbfs(p.max(axis=0), eps)
        if return_linear:
            out["sxx"] = p
            out["sxx_med"] = p_med
        return out

    return sti_fn


def to_plane_major(packed: np.ndarray) -> np.ndarray:
    """(nsamp, nsub, 2) time-major packed -> (nsub*2, nsamp) plane-major
    float32 (host-side; one transpose)."""
    nsamp, nsub, _ = packed.shape
    return np.ascontiguousarray(
        np.moveaxis(packed.astype(np.float32), 0, -1).reshape(nsub * 2, nsamp)
    )


def to_reference_layout(sxx: np.ndarray) -> np.ndarray:
    """(ntime, nsub, nfft) device layout -> (nfft, ntime, nsub) reference
    layout (reference: drfProc.py:365)."""
    return np.moveaxis(np.asarray(sxx), -1, 0)


def shifted_freqs(nfft: int, sample_rate) -> np.ndarray:
    """fftshifted two-sided frequency axis in Hz, float64 on host
    (reference: drfProc.py:398, drfview.py:988)."""
    return np.fft.fftshift(np.fft.fftfreq(nfft, 1.0 / float(sample_rate)))
