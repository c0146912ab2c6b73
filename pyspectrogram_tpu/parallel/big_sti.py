"""STI for giant FFTs: the transform itself sharded over the mesh.

For the reference's largest transforms (up to 2^20,
reference: drfview.py:475), the per-column FFT can run as the distributed
4-step algorithm (see parallel.dist_fft): local DFT stage, twiddle, one
all-to-all transpose, local DFT stage — SURVEY.md section 5's
"multi-device 4-step FFT" scaling tier. The rest of the STI chain
(window, |X|^2, Welch average, fftshift, median, dB) is elementwise over
the sharded frequency axis, so the all-to-all per segment is the only
collective; the time median needs none (time is unsharded). The pipeline
takes this tier only where column sharding cannot place a request
(models.sti.StiPipeline._use_bigfft).

The local DFT stages depend on ``precision``:

* "exact"    — XLA FFT stages (cuFFT on the GPU), float32 throughout.
* "balanced" — GEMM-DFT stages: 3 real GEMMs via Gauss's identity with
               host-split hi/lo bf16 constants, 3 single-precision-pass
               products each.
* "display"  — GEMM-DFT stages, one pass per product.

The GEMM tiers run at ``Precision.DEFAULT``, which is TF32 for float32
operands on the GPU; they are the only place the precision knob changes
numerics there.

Layout: a frame x reshapes to x2[p, q] = x[p*n2 + q] with the q axis
explicit and SHARDED (each device holds all p for its q-slice, which is
what makes stage 1 local). After the all-to-all the shard holds all q for
a k1-slice, making stage 2 local. Results come back as the "k-matrix"
(..., n1, n2) with X[n1*k2 + k1] = Xm[k1, k2], sharded over k1 rows —
contiguous shards of a coherent global array. ``to_freq_order`` converts
an assembled k-matrix to the natural fftshifted frequency axis.

Display tier: pass ``tile`` (a display.TileSpec) and each SHARD gathers
its own plot bins out of its k1-slice inside the shard_map, all-gathers
only those (~plot_n floats — never the (ntime, nsub, nfft) cube),
reassembles plot order with a static take, quantizes (color range as a
runtime operand) and returns a uint8 (ntime, nsub, plot_n) tile — the
float spectra never leave device memory and never replicate across devices,
exactly like the single-device display path (north star, BASELINE.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyspectrogram_tpu.kernels.gemm_fft import dft_mat, twiddle_mat
from pyspectrogram_tpu.ops.stft import median_over_time, to_dbfs
from pyspectrogram_tpu.ops.windows import WindowSpec, get_window
from pyspectrogram_tpu.parallel.dist_fft import split_for_devices


def frames_to_x2(frames_pm: np.ndarray, nfft: int, nseg: int, n1: int,
                 n2: int) -> np.ndarray:
    """Host reshape: (ntime, nsub, 2, nseg*nfft) plane-split frames ->
    (ntime, nsub, 2, nseg, n1, n2) — a free view (row-major)."""
    ntime, nsub = frames_pm.shape[:2]
    return frames_pm.reshape(ntime, nsub, 2, nseg, n1, n2)


def to_freq_order(kmatrix: np.ndarray) -> np.ndarray:
    """Assembled k-matrix (..., n1, n2) -> natural fftshifted (..., nfft).

    The distributed stages produce Xm[k1, k2] with frequency index
    k = n1*k2 + k1 (already rolled by nfft/2 along k2 on device), so the
    natural axis is the transpose-flatten.
    """
    a = np.asarray(kmatrix)
    n1, n2 = a.shape[-2:]
    return np.swapaxes(a, -1, -2).reshape(a.shape[:-2] + (n1 * n2,))


def _dft_mats(n: int):
    """(Dr, Di) of the n-point DFT matrix, float64 -> float32 (the shared
    kernels.gemm_fft.dft_mat construction)."""
    d = dft_mat(n)
    return d.real.astype(np.float32), d.imag.astype(np.float32)


def _split_bf16(m: np.ndarray) -> np.ndarray:
    """Host-side error-feedback split D = hi + lo with hi = bf16(D), for
    the balanced tier: three single-pass bf16 products approximate one
    float32 product."""
    hi = m.astype(np.float32).astype(jnp.bfloat16).astype(np.float32)
    return np.stack([hi, m - hi]).astype(np.float32)


def _triple(dr: np.ndarray, di: np.ndarray, precision: str):
    """Gauss-identity constant triple (dr, di, dr+di), hi/lo-split for
    the balanced tier (_split_bf16)."""
    mats = (dr, di, dr + di)
    if precision == "balanced":
        return tuple(_split_bf16(m) for m in mats)
    return mats


def _tier_cdot(precision: str, eq: str):
    """Complex contraction ``einsum(eq, D, x)`` on real planes with
    Gauss's 3-multiplication identity:
        k1 = (Dr+Di)*xr, k2 = Dr*(xi-xr), k3 = Di*(xr+xi)
        real = k1 - k3, imag = k1 + k2
    Returns f(d3, xr, xi) -> (yr, yi)."""
    # DEFAULT precision only: call sites are gated by use_gemm =
    # precision != "exact" (the exact tier runs XLA FFT stages), so an
    # exact/HIGHEST branch would be dead code
    es = functools.partial(
        jnp.einsum,
        precision=jax.lax.Precision.DEFAULT,
        preferred_element_type=jnp.float32,
    )
    if precision == "balanced":
        def mdot(m, x):
            mh, ml = m[0], m[1]
            xh = x.astype(jnp.bfloat16).astype(jnp.float32)
            xl = x - xh
            return es(eq, mh, xh) + es(eq, mh, xl) + es(eq, ml, xh)
    else:
        def mdot(m, x):
            return es(eq, m, x)

    def cdot(d3, xr, xi):
        dr, di, dsum = d3
        k1 = mdot(dsum, xr)
        k2 = mdot(dr, xi - xr)
        k3 = mdot(di, xr + xi)
        return k1 - k3, k1 + k2

    return cdot


def make_bigfft_sti_fn(mesh: Mesh, axis: str, *, tile=None, **kw):
    """Jitted distributed-FFT STI — see :func:`_make_bigfft_sti_fn` for
    the full contract. This uncached wrapper canonicalizes the display
    tile's color range (``TileSpec.crop_key``) BEFORE the compile cache,
    so specs differing only in cmin/cmax hit the same compiled shard_map
    program whether or not the caller passed ``spec.crop_key()`` — a
    re-clim must never cost a recompile (same two-level pattern
    as ops.stft.make_sti_fn_pm)."""
    return _make_bigfft_sti_fn(
        mesh, axis, tile=tile.crop_key() if tile is not None else None,
        **kw)


@functools.lru_cache(maxsize=16)
def _make_bigfft_sti_fn(
    mesh: Mesh,
    axis: str,
    *,
    nfft: int,
    nint: int = 1,
    mode: str = "welch",
    window: WindowSpec = ("kaiser", 1.7),
    ref: float = 1.0,
    eps: float = 1e-15,
    precision: str = "exact",
    tile=None,
):
    """Jitted STI whose per-column FFT is distributed over ``mesh[axis]``.

    Returned ``f(x2, qparams=None)``:
      x2: (ntime, nsub, 2, nseg, n1, n2) float32 — or any real dtype
          (raw int16 planes transfer at half the bytes and widen on
          device) — see frames_to_x2; the last (q) axis sharded with
          ``f.input_sharding``;
      qparams: display-tile color range operand (TileSpec.qparams);
          REQUIRED with ``tile`` (the factory tile is crop_key-
          canonicalized, so there is no meaningful default range).
    Without ``tile`` returns {"sxx_dbfs": (ntime, nsub, n1, n2) k-matrix
    dB, sharded over the n1 (k1) axis; "sxx_med_dbfs": (nsub, n1, n2)
    likewise} — convert assembled arrays with :func:`to_freq_order`.
    With ``tile`` (a display.TileSpec) the float spectra stay on device:
    returns {"tile": (ntime, nsub, plot_n) uint8, "sxx_med_dbfs":
    k-matrix} — compiled programs key on the CROP plan only, the color
    range rides in ``qparams`` (pass ``tile.crop_key()``-equal specs to
    share the program; a re-clim must not recompile, TileSpec.crop_key).
    """
    ndev = mesh.shape[axis]
    n1, n2 = split_for_devices(nfft, ndev)
    nseg = nint if mode == "welch" else 1

    win64 = get_window(window, nfft)
    inv_scale = np.float32(
        1.0 / (float(win64.sum()) ** 2 * float(ref) ** 2 * nseg))
    win2 = win64.reshape(n1, n2).astype(np.float32)
    tw = twiddle_mat(n1, n2, nfft)
    twr = tw.real.astype(np.float32)
    twi = tw.imag.astype(np.float32)
    # tier-dependent local stages (module docstring): exact keeps XLA's
    # FFT HLO; balanced/display run GEMM-DFT stages. GEMM constants ride
    # as replicated operands (P()) rather than baked HLO constants: at
    # 2^20 the triples are ~24 MB and constants that size bloat the
    # program and its compile time.
    use_gemm = precision != "exact"
    if use_gemm:
        d1_3 = _triple(*_dft_mats(n1), precision)
        d2_3 = _triple(*_dft_mats(n2), precision)
        # stage 1 contracts p (axis -2): D1[k1,p] x[...,p,q] -> [...,k1,q]
        cdot1 = _tier_cdot(precision, "kp,abpq->abkq")
        # stage 2 contracts q (axis -1): D2[q,k2] z[...,p,q] -> [...,p,k2]
        # (D2 is symmetric, so contracting its first axis is the DFT)
        cdot2 = _tier_cdot(precision, "qk,abpq->abpk")
    else:
        d1_3 = d2_3 = ()

    if tile is not None:
        # per-shard gather tables: plot bin f (natural fftshifted order)
        # lives at k-matrix row k1 = f % n1 — i.e. on shard k1 // rows —
        # and, in the UNROLLED linear power (the fftshift roll is folded
        # into the index instead of paid as a full-array pass), at local
        # flat position (k1 % rows) * n2 + (f // n1 - n2/2) % n2. Each
        # shard gathers its own bins (padded to the max per-shard count),
        # all-gathers only those (~plot_n floats total, never the
        # (ntime, nsub, n1, n2) cube), and a tiny static take reassembles
        # plot order. Gathering OUTSIDE the shard_map instead would make
        # GSPMD replicate the full float cube onto every device to
        # execute the flattened-axis gather — the exact large-float
        # traffic tile mode exists to avoid (round-4 review finding).
        f_nat = np.asarray(tile.plot_indices, np.int64)
        rows = n1 // ndev
        k1 = f_nat % n1
        shard_of = k1 // rows
        local_flat = (k1 % rows) * n2 + (f_nat // n1 - n2 // 2) % n2
        m_pad = max(1, int(np.bincount(shard_of, minlength=ndev).max()))
        idx_mat = np.zeros((ndev, m_pad), np.int32)
        reorder = np.zeros(len(f_nat), np.int32)
        fill = np.zeros(ndev, np.int64)
        for pos, (s, lf) in enumerate(zip(shard_of, local_flat)):
            idx_mat[s, fill[s]] = lf
            reorder[pos] = s * m_pad + fill[s]
            fill[s] += 1
        idx_mat_j = jnp.asarray(idx_mat)
        reorder_j = jnp.asarray(reorder)

        from pyspectrogram_tpu.display.tile import quantize_db_tile

    def local(x2, winr, twr_s, twi_s, qparams, *dmats):
        # x2 shard: (ntime, nsub, 2, nseg, n1, n2/ndev) — all p, a q-slice
        ntime, nsub = x2.shape[0], x2.shape[1]
        d1 = dmats[:3]
        d2 = dmats[3:]

        def one_seg(seg):
            # raw integer planes ship at half the bytes and widen here,
            # per shard (dBFS normalization rides inv_scale)
            xr = x2[:, :, 0, seg].astype(jnp.float32) * winr
            xi = x2[:, :, 1, seg].astype(jnp.float32) * winr
            # stage 1: DFT along p (full on this shard)
            if use_gemm:
                yr, yi = cdot1(d1, xr, xi)
            else:
                y = jnp.fft.fft(jax.lax.complex(xr, xi), axis=-2)
                yr, yi = jnp.real(y), jnp.imag(y)
            zr = yr * twr_s - yi * twi_s
            zi = yr * twi_s + yi * twr_s
            # all-to-all: trade the q shard for a k1 shard — ONE
            # collective for both planes (stacked), keeping the step's
            # interconnect traffic a single transfer
            z = jnp.stack([zr, zi])       # (2, ntime, nsub, n1, n2/ndev)
            z = z.reshape(2, ntime, nsub, ndev, n1 // ndev, n2 // ndev)
            z = jax.lax.all_to_all(z, axis, split_axis=3, concat_axis=3,
                                   tiled=False)
            # axis 3 now indexes the SOURCE shard = global q block
            z = jnp.moveaxis(z, 3, 4).reshape(
                2, ntime, nsub, n1 // ndev, n2)
            # stage 2: DFT along q (full on this shard)
            if use_gemm:
                Xr, Xi = cdot2(d2, z[0], z[1])
            else:
                X = jnp.fft.fft(jax.lax.complex(z[0], z[1]), axis=-1)
                Xr, Xi = jnp.real(X), jnp.imag(X)
            return Xr * Xr + Xi * Xi

        p = one_seg(0)
        for seg in range(1, nseg):
            p = p + one_seg(seg)
        p = p * inv_scale                  # (ntime, nsub, n1/ndev, n2)
        if tile is not None:
            # median from the unrolled power, rolled AFTER the (small)
            # time reduction — same values as roll-then-median (the roll
            # permutes k2, the median is elementwise over time)
            med = to_dbfs(jnp.roll(median_over_time(p), n2 // 2,
                                   axis=-1), eps)
            sidx = jax.lax.axis_index(axis)
            g = p.reshape(ntime, nsub, rows * n2)[..., idx_mat_j[sidx]]
            g = jax.lax.all_gather(g, axis)    # (ndev, ntime, nsub, m)
            g = jnp.moveaxis(g, 0, 2).reshape(ntime, nsub, ndev * m_pad)
            db = to_dbfs(g[..., reorder_j], eps)
            return quantize_db_tile(db, tile, qparams), med
        # fftshift: k + nfft/2 <=> k2 += n2/2 — a local roll along k2
        p = jnp.roll(p, n2 // 2, axis=-1)
        p_med = median_over_time(p)        # (nsub, n1/ndev, n2)
        return to_dbfs(p, eps), to_dbfs(p_med, eps)

    dspecs = (P(),) * len(d1_3 + d2_3)
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(None, None, None, None, None, axis),
                  P(None, axis), P(None, axis), P(None, axis),
                  P()) + dspecs,
        out_specs=((P() if tile is not None
                    else P(None, None, axis, None)),
                   P(None, axis, None)),
        check_vma=False,
    )

    win_j = jnp.asarray(win2)
    twr_j = jnp.asarray(twr)
    twi_j = jnp.asarray(twi)
    d_j = tuple(jnp.asarray(m) for m in d1_3 + d2_3)

    if tile is None:
        @jax.jit
        def sti(x2: jax.Array) -> dict:
            sxx, med = fn(x2, win_j, twr_j, twi_j,
                          jnp.zeros(2, jnp.float32), *d_j)
            return {"sxx_dbfs": sxx, "sxx_med_dbfs": med}
    else:
        @jax.jit
        def _sti_tiled(x2: jax.Array, qparams) -> dict:
            t, med = fn(x2, win_j, twr_j, twi_j,
                        jnp.asarray(qparams, jnp.float32), *d_j)
            return {"tile": t, "sxx_med_dbfs": med}

        def sti(x2: jax.Array, qparams=None) -> dict:
            # the factory's tile is crop_key-canonicalized (cmin 0,
            # cmax 1), so there is NO meaningful default color range —
            # the real range always arrives as the runtime operand
            if qparams is None:
                raise ValueError(
                    "tile mode requires the color-range operand: pass "
                    "the display TileSpec's .qparams")
            return _sti_tiled(x2, qparams)

    sti.input_sharding = NamedSharding(
        mesh, P(None, None, None, None, None, axis))
    sti.n1n2 = (n1, n2)
    sti.nseg = nseg
    return sti
