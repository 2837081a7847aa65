"""Banded precision operators: storage, conversion, and matvec/quadratic
forms with O(N*b) cost — block-banded GEMM tiles with a diagonal-form XLA
fallback.

The reference's ``bandsize`` option truncates C^{-1}, K^{-1}, m to a band but
keeps storing and multiplying them DENSE (magi_v2.py:271-274; SURVEY.md §5),
so only the statistics change, not the FLOPs or memory. Here the band is
real: diagonal-offset storage (D, 2b+1, N) plus a BLOCK-banded
(nb, 2hw+1, 128, 128) tile form, which turn the O(N^2) per-leapfrog cost
into O(N*b) and the O(D*N^2) memory into O(D*N*b) — the honest "blockwise
attention" analog for this workload, and what makes N_I >= 4k grids
(Lorenz dense config) fit on one device.

Two apply paths:
- block_banded_matvec: 128x128 tiles contracted in one batched einsum,
  which XLA lowers to batched GEMMs (cuBLAS on the GPU). Plain jnp, no
  hand-written kernel: a shifted-accumulate diagonal kernel would trade
  dense GEMM tiles for unaligned elementwise reads.
- banded_matvec: diagonal-offset shifted accumulate in plain XLA with a
  custom VJP (transposed band) — the reference form used for tests and
  small-N CPU work.
"""

from __future__ import annotations



import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# banded storage
# ---------------------------------------------------------------------------

def dense_to_banded(A, bandwidth: int):
    """(..., N, N) dense -> (..., 2b+1, N) diagonal-offset storage.

    band[..., b + k, i] = A[..., i, i + k] for k in [-b, b] (zero-padded
    outside the matrix).
    """
    A = jnp.asarray(A)
    N = A.shape[-1]
    b = bandwidth
    rows = []
    for k in range(-b, b + 1):
        diag = jnp.diagonal(A, offset=k, axis1=-2, axis2=-1)
        # diag has length N - |k|; pad so that entry i corresponds to row i
        if k >= 0:
            pad = (0, k)
        else:
            pad = (-k, 0)
        widths = [(0, 0)] * (A.ndim - 2) + [pad]
        rows.append(jnp.pad(diag, widths))
    return jnp.stack(rows, axis=-2)


def banded_to_dense(band):
    """Inverse of dense_to_banded (for tests)."""
    band = np.asarray(band)
    *lead, two_b1, N = band.shape
    b = (two_b1 - 1) // 2
    out = np.zeros((*lead, N, N), band.dtype)
    for k in range(-b, b + 1):
        d = band[..., b + k, :]
        for i in range(max(0, -k), min(N, N - k)):
            out[..., i, i + k] = d[..., i]
    return out


# ---------------------------------------------------------------------------
# XLA reference implementation (also the CPU/interpret fallback)
# ---------------------------------------------------------------------------

def _banded_matvec_xla(band, x):
    """y[i] = sum_k band[b+k, i] * x[i+k]; shapes (..., 2b+1, N), (..., N)."""
    two_b1, N = band.shape[-2], band.shape[-1]
    b = (two_b1 - 1) // 2
    y = jnp.zeros_like(x)
    for k in range(-b, b + 1):
        xs = jnp.roll(x, -k, axis=-1)
        # zero the wrapped-around region
        idx = jnp.arange(N)
        valid = (idx + k >= 0) & (idx + k < N)
        y = y + band[..., b + k, :] * jnp.where(valid, xs, 0.0)
    return y


def transpose_band(band):
    """Banded storage of A^T given banded storage of A.

    (A^T)[i, i+k] = A[i+k, i] -> band_T[b+k, i] = band[b-k, i+k]."""
    two_b1 = band.shape[-2]
    b = (two_b1 - 1) // 2
    rows = []
    for k in range(-b, b + 1):
        src = band[..., b - k, :]
        rows.append(jnp.roll(src, -k, axis=-1))
    out = jnp.stack(rows, axis=-2)
    # rolled-in garbage is multiplied by out-of-range x in matvec only when
    # |i+k| outside [0,N) — masked there, so no cleanup needed; but zero it
    # anyway for exactness of the stored representation
    N = band.shape[-1]
    idx = jnp.arange(N)
    ks = jnp.arange(-b, b + 1).reshape((1,) * (band.ndim - 2) + (two_b1, 1))
    valid = (idx + ks >= 0) & (idx + ks < N)
    return jnp.where(valid, out, 0.0)


@jax.custom_vjp
def banded_matvec(band, x):
    """y = A @ x with A in banded storage.

    band: (..., 2b+1, N), x: (..., N) with broadcast-compatible leading dims.
    """
    return _banded_matvec_impl(band, x)


def _banded_matvec_impl(band, x):
    lead = jnp.broadcast_shapes(band.shape[:-2], x.shape[:-1])
    two_b1, N = band.shape[-2], band.shape[-1]
    bandf = jnp.broadcast_to(band, lead + (two_b1, N)).reshape(-1, two_b1, N)
    xf = jnp.broadcast_to(x, lead + (N,)).reshape(-1, N)
    yf = _banded_matvec_xla(bandf, xf)
    return yf.reshape(lead + (N,))


def _banded_matvec_fwd(band, x):
    return _banded_matvec_impl(band, x), (band, x)


def _banded_matvec_bwd(res, g):
    band, x = res
    # d/dx: A^T g  (banded matvec with transposed band)
    band_t = transpose_band(band)
    gx = _banded_matvec_impl(band_t, g)
    # d/dband[b+k, i] = g[i] * x[i+k]
    two_b1, N = band.shape[-2], band.shape[-1]
    b = (two_b1 - 1) // 2
    idx = jnp.arange(N)
    rows = []
    for k in range(-b, b + 1):
        xs = jnp.roll(x, -k, axis=-1)
        valid = (idx + k >= 0) & (idx + k < N)
        rows.append(g * jnp.where(valid, xs, 0.0))
    gband = jnp.stack(rows, axis=-2)
    # un-broadcast to original shapes
    gx = _sum_to_shape(gx, x.shape)
    gband = _sum_to_shape(gband, band.shape)
    return gband, gx


def _sum_to_shape(v, shape):
    extra = v.ndim - len(shape)
    if extra > 0:
        v = v.sum(axis=tuple(range(extra)))
    for i, (a, b) in enumerate(zip(v.shape, shape)):
        if a != b:
            v = v.sum(axis=i, keepdims=True)
    return v.reshape(shape)


banded_matvec.defvjp(_banded_matvec_fwd, _banded_matvec_bwd)


def banded_quadratic_form(band, x):
    """x^T A x summed over all leading (batch) axes; A in banded storage."""
    return jnp.sum(x * banded_matvec(band, x))


# ---------------------------------------------------------------------------
# Block-banded form — the GEMM path
# ---------------------------------------------------------------------------
#
# Diagonal-offset banded matvecs are elementwise work with unaligned
# shifted reads. The BLOCK-banded layout instead partitions rows into
# T=128 tiles; a half-bandwidth b touches hw = ceil(b/T) neighbor tiles each
# side, so A becomes (nb, 2hw+1, T, T) dense tiles and the matvec is ONE
# batched (T, T) @ (T,) einsum — GEMMs once the chain axis is batched in.
# ~2x the MACs of diagonal storage, natively differentiable (pure
# gather-free jnp at apply time), O(N * (2hw+1) * T) memory. T=128 was
# chosen for the previous accelerator's 128x128 matrix unit; it is a valid
# GEMM tile on the GPU and has not been re-tuned there.


def banded_to_blocks(band, T: int = 128):
    """(..., 2b+1, N) diagonal storage -> (..., nb, nw, T, T) block tiles.

    block[q, s, r, c] = A[q*T + r, (q + s - hw)*T + c]; zero outside the
    band/matrix. Setup-time conversion (gathers are fine here).
    """
    band = jnp.asarray(band)
    two_b1, N = band.shape[-2], band.shape[-1]
    b = (two_b1 - 1) // 2
    hw = -(-b // T)  # ceil
    nw = 2 * hw + 1
    nb = -(-N // T)

    q = jnp.arange(nb)[:, None, None, None]
    s = jnp.arange(nw)[None, :, None, None]
    r = jnp.arange(T)[None, None, :, None]
    c = jnp.arange(T)[None, None, None, :]
    i = q * T + r                       # global row
    j = (q + s - hw) * T + c            # global col
    k = j - i
    valid = (jnp.abs(k) <= b) & (i < N) & (j >= 0) & (j < N)
    diag_idx = jnp.clip(b + k, 0, two_b1 - 1)
    row_idx = jnp.clip(i, 0, N - 1)
    blocks = band[..., diag_idx, row_idx]
    return jnp.where(valid, blocks, 0.0)


def _block_banded_matvec_core(blocks, x, hw_lo: int, hw_hi: int):
    """y = A @ x for block tiles covering column tiles [q - hw_lo, q + hw_hi].

    blocks: (*B, nb, hw_lo + hw_hi + 1, T, T); x: (*E, *B, N) — extra
    leading dims *E (e.g. chains) become GEMM free dimensions. N <= nb*T
    (zero-padded internally). Pure einsum + pad/slice — lowers to batched
    GEMMs and differentiates natively.

    Performance note: the blocks must NOT be broadcast across *E — keeping
    them chain-free lets XLA contract (s, t) as one (T, nw*T) x (nw*T, E)
    GEMM per (batch, tile); a broadcast version runs as batched matvecs
    instead of GEMMs.
    """
    blocks = jnp.asarray(blocks)
    x = jnp.asarray(x)
    nb, nw, T = blocks.shape[-4], blocks.shape[-3], blocks.shape[-2]
    assert nw == hw_lo + hw_hi + 1
    N = x.shape[-1]
    B = blocks.shape[:-4]
    nB = len(B)
    E = x.shape[: x.ndim - 1 - nB]
    if x.shape[x.ndim - 1 - nB : -1] != B:
        x = jnp.broadcast_to(x, E + B + (N,))

    pad_tail = nb * T - N
    widths = [(0, 0)] * (x.ndim - 1) + [(hw_lo * T, pad_tail + hw_hi * T)]
    xp = jnp.pad(x, widths)
    xb = xp.reshape(E + B + (nb + hw_lo + hw_hi, T))
    windows = jnp.stack(
        [xb[..., s : s + nb, :] for s in range(nw)], axis=-2
    )  # (*E, *B, nb, nw, T)

    # flatten *E into one GEMM free axis 'c'
    cdim = 1
    for e in E:
        cdim *= e
    windows_f = windows.reshape((cdim,) + B + (nb, nw, T))
    y = jnp.einsum("...qsrt,c...qst->c...qr", blocks, windows_f)
    y = y.reshape(E + B + (nb * T,))
    return y[..., :N]


def block_banded_matvec(blocks, x):
    """y = A @ x with A in symmetric-window block-banded storage
    (*B, nb, 2hw+1, T, T) — see _block_banded_matvec_core."""
    nw = jnp.asarray(blocks).shape[-3]
    hw = (nw - 1) // 2
    return _block_banded_matvec_core(blocks, x, hw, hw)


def banded_to_blocks_upper(band, T: int = 128):
    """Block tiles of an UPPER-triangular band (lower rows of ``band`` must
    be zero): (..., nb, hw+1, T, T), where s=0 is the diagonal tile. Halves
    the tile count vs the symmetric layout — triangular factors like the
    Gauss-Newton whitening W would otherwise spend half their MACs on
    structurally-zero tiles (the hottest matvec of the banded leapfrog)."""
    full = banded_to_blocks(band, T)
    nw = full.shape[-3]
    hw = (nw - 1) // 2
    return full[..., hw:, :, :]


def block_banded_matvec_upper(blocks, x):
    """y = A @ x with A upper-triangular in banded_to_blocks_upper storage."""
    nw = jnp.asarray(blocks).shape[-3]
    return _block_banded_matvec_core(blocks, x, 0, nw - 1)


def block_banded_quadratic_form(blocks, x):
    return jnp.sum(x * block_banded_matvec(blocks, x))


def banded_diag_tile_inverses(blocks, N: int | None = None):
    """(nb, T, T) inverses of the diagonal tiles of an upper block-banded
    factor (banded_to_blocks_upper layout), for
    block_banded_triangular_solve_upper.

    Compute these ONCE at setup in float64 and cast: the fused per-tile
    inverse-GEMM then runs at the matmul precision the caller pins,
    whereas an in-graph triangular_solve is a monolithic XLA op whose
    internal block expansion need not honor
    ``jax.default_matmul_precision`` — measured on the banded GN sampler
    at Lorenz N_I=1025: in-graph solves collapsed the adapted step size
    to 1.6e-7 (reduced-precision internal passes at kappa(U) ~ 2e3),
    while the f64-precomputed tile inverses behave like the CPU f64
    oracle.

    Rows at global index >= N (tile zero padding) get a unit diagonal so
    the tile is invertible; the padded solution stays exactly 0.
    """
    blocks = jnp.asarray(blocks)
    nb, T = blocks.shape[-4], blocks.shape[-2]
    if N is None:
        N = nb * T
    q = jnp.arange(nb)[:, None]
    r = jnp.arange(T)[None, :]
    pad_fix = ((q * T + r) >= N).astype(blocks.dtype)   # (nb, T)
    diag_tiles = (
        blocks[:, 0]
        + jnp.eye(T, dtype=blocks.dtype)[None] * pad_fix[:, :, None]
    )
    return jnp.linalg.inv(diag_tiles)


def block_banded_triangular_solve_upper(blocks, y, diag_inv=None):
    """Solve U x = y for upper-triangular banded U in
    banded_to_blocks_upper layout; y: (*E, N).

    Back substitution over block rows as one lax.scan (sequential depth
    nb = ceil(N/T)), each step: one (T, T) tile-inverse GEMM plus nwu-1
    (T, T) GEMMs against the rolling buffer of already-solved blocks —
    all batched over *E as GEMMs.

    This is the EXACT unwhitening x = U^{-1} z for the banded
    Gauss-Newton Cholesky factor Lambda = U'U: unlike the band-truncated
    inverse W ~= band(U^{-1}), whose columns decay too slowly to truncate
    (measured on Lorenz N_I=1025: 92% of column norm beyond distance 303,
    leaving eig(W'LamW) spread over 14 decades), the solve gives
    U^{-T} Lambda U^{-1} = I identically. f32-safe WHEN the diagonal-tile
    inverses are precomputed in f64 (banded_diag_tile_inverses — see its
    docstring for the precision trap this avoids): error
    ~kappa(U)*eps_f32 = sqrt(kappa(Lambda))*eps ~ 2e3 * 6e-8 ~ 1e-4
    relative (kappa(Lambda) measured 5e6).

    Cost per apply: O(N * b * T) MACs + nb-deep sequential chain.
    """
    blocks = jnp.asarray(blocks)
    y = jnp.asarray(y)
    nb, nwu, T = blocks.shape[-4], blocks.shape[-3], blocks.shape[-2]
    N = y.shape[-1]
    E = y.shape[:-1]
    B = int(np.prod(E, dtype=np.int64)) if E else 1
    yf = y.reshape(B, N)
    pad_tail = nb * T - N
    yb = jnp.pad(yf, ((0, 0), (0, pad_tail))).reshape(B, nb, T)
    yb = jnp.swapaxes(yb, 0, 1)                     # (nb, B, T)

    if diag_inv is None:
        diag_inv = banded_diag_tile_inverses(blocks, N)
    diag_inv = jnp.asarray(diag_inv, blocks.dtype)

    off_tiles = blocks[:, 1:]                        # (nb, nwu-1, T, T)

    def step(buf, inputs):
        # buf: (B, nwu-1, T) = [x_{i+1}, ..., x_{i+nwu-1}]
        d_inv, o_tiles, y_i = inputs
        contrib = jnp.einsum("src,bsc->br", o_tiles, buf)
        x_i = jnp.einsum("rc,bc->br", d_inv, y_i - contrib)
        buf = jnp.concatenate([x_i[:, None, :], buf[:, :-1, :]], axis=1)
        return buf, x_i

    buf0 = jnp.zeros((B, max(nwu - 1, 1), T), blocks.dtype)
    _, xs = jax.lax.scan(
        step, buf0, (diag_inv, off_tiles, yb), reverse=True
    )                                                # (nb, B, T)
    x = jnp.swapaxes(xs, 0, 1).reshape(B, nb * T)[:, :N]
    return x.reshape(E + (N,))
