"""Gauss-Newton posterior preconditioning for the MAGI sampler.

Measurement-driven design (SEIR vignette, N_I=161):

- centered X-space: curvature ~1e8, NUTS eps ~9e-3, theta ESS ~8
- prior whitening (z = C^{-1/2} x): ESS 45 but trees max out at depth 10 —
  the manifold operator m C^{1/2} is still stiff
- per-component posterior whitening: eps 2.2e-2, ESS ~11 — the remaining
  stiffness is the ODE Jacobian coupling J_f' K^{-1} J_f, which is
  CROSS-component (f_d depends on all components pointwise in time), so no
  per-component factor can capture it.

This module builds the full Gauss-Newton precision of the X block at the
initialization point:

    Lambda = [ blkdiag_d(C_d^{-1}) + (d r/d X)' blkdiag_d(K_d^{-1}) (d r/d X) ] / beta
             + diag(observed)/sigma^2

    r_d(n) = f_d(t_n, X_n, theta) - m_d (x_d - mu_d),
    d r_d(n) / d X[m, e] = delta_{nm} J_d,e(t_n) - m_d[n, m] delta_{e,d}

with J the pointwise ODE Jacobian at (Xhat_init, thetas_init). Sampling
z = L^{-1}(x - mu) with L = Lambda^{-1/2} makes the entire quadratic
structure of the posterior ~unit curvature; only the deviation of f from
its linearization remains. The map is linear and fixed, so the posterior
over X is IDENTICAL. Cost: one (N*D)^2 assembly + one (N*D) eigh at setup.

Scaling note: the dense factor L = Lambda^{-1/2} costs an O((ND)^2) matvec
per leapfrog — fine through N_I ~ 1k (38 MB f32 at N_I=1025, D=3) but
dominant beyond. The BANDED path (build_gn_cholesky_banded +
make_tempered_logp_grad_gn_banded) exploits that Lambda is block-banded
(bandwidth ~ kernel bandsize x D in the interleaved n*D+d flat index):
banded Cholesky Lambda = U'U on the host, whiten z = U (x - mu), and
unwhiten per leapfrog by the EXACT O(ND*b) block-banded back substitution
x = mu + U^{-1} z (ops/banded.py) — whitened curvature identically I.
A truncated-inverse W ~= band(U^{-1}) pure-matvec variant was measured
and rejected: U^{-1}'s columns decay too slowly to truncate (92% of
column norm beyond distance 303 on Lorenz N_I=1025), leaving the
"whitened" spectrum spread over 14 decades.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def pointwise_ode_jacobian(f_vec, I, Xhat, thetas):
    """J[n, d, e] = d f_d(t_n, x_n) / d x_e — (N, D, D), at fixed theta."""
    I = jnp.asarray(I).reshape(-1, 1)
    Xhat = jnp.asarray(Xhat)
    thetas = jnp.asarray(thetas)

    def row(t_n, x_n):
        return jax.jacfwd(
            lambda x: f_vec(t_n[None, :], x[None, :], thetas)[0]
        )(x_n)

    return jax.vmap(row)(I, Xhat)  # (N, D, D)


def gauss_newton_precision(
    C_invs, m_ds, K_invs, beta, obs_mask, sigma_sqs, J,
    C_inv_sqrts=None, K_inv_sqrts=None,
):
    """Assemble the (N*D, N*D) Gauss-Newton precision of the X block.

    obs_mask: (N, D) 1.0 where observed; sigma_sqs: (D,); J: (N, D, D).
    Index order matches X.ravel() (row-major: flat = n*D + d).

    When the factored forms R = C^{-1/2}, S = K^{-1/2} are supplied
    (sym_sqrt with negative eigenvalues clamped — the operators the sampler
    actually evaluates t1/t2 with), the precision is built from R'R / S'S
    instead of the raw matrices. This matters whenever bandsize truncation
    made the raw C^{-1}/K^{-1} indefinite (measured on Lorenz N_I=1025,
    bandsize=100: raw-Lambda eigenvalues reach -5.6e9 relative, so the
    "whitened" target was indefinite and the sampler froze at eps ~1e-5);
    with the clamped factors, Lambda is the exact PSD Gauss-Newton
    curvature of the target being sampled.
    """
    if C_inv_sqrts is not None:
        R = jnp.asarray(C_inv_sqrts)
        C_invs = jnp.einsum("dmn,dmM->dnM", R, R)
    if K_inv_sqrts is not None:
        S = jnp.asarray(K_inv_sqrts)
        K_invs = jnp.einsum("dmn,dmM->dnM", S, S)
    C_invs = jnp.asarray(C_invs)
    m_ds = jnp.asarray(m_ds)
    K_invs = jnp.asarray(K_invs)
    J = jnp.asarray(J)
    D, N = C_invs.shape[0], C_invs.shape[1]

    lam = jnp.zeros((N, D, N, D), C_invs.dtype)
    for d in range(D):
        Kd, Ad = K_invs[d], m_ds[d]
        Bd = J[:, d, :]                      # (N, D): d f_d / d x_e
        KA = Kd @ Ad
        AKA = Ad.T @ KA
        lam = lam + jnp.einsum("me,mM,Mf->meMf", Bd, Kd, Bd)
        lam = lam.at[:, :, :, d].add(-jnp.einsum("me,mM->meM", Bd, KA))
        lam = lam.at[:, d, :, :].add(-jnp.einsum("Mm,Mf->mMf", KA, Bd))
        lam = lam.at[:, d, :, d].add(AKA + C_invs[d])

    lam = lam.reshape(N * D, N * D) / jnp.asarray(beta, lam.dtype)
    obs_diag = (jnp.asarray(obs_mask) / jnp.asarray(sigma_sqs)[None, :]).ravel()
    lam = lam + jnp.diag(obs_diag.astype(lam.dtype))
    return lam


def factor_precision(lam, floor_ratio: float = 1e-12):
    """(L, L_inv) = (Lambda^{-1/2}, Lambda^{1/2}) via symmetric eigh."""
    lam = jnp.asarray(lam)
    w, V = jnp.linalg.eigh((lam + lam.T) / 2.0)
    w = jnp.maximum(w, floor_ratio * jnp.max(w))
    L = (V * (w ** -0.5)[None, :]) @ V.T
    L_inv = (V * (w ** 0.5)[None, :]) @ V.T
    return L, L_inv


def build_gn_whitening(
    model, sigma_sqs_init=None, C_inv_sqrts=None, K_inv_sqrts=None
):
    """(L, L_inv, A1) full-state whitening factors from a fitted MAGI_v2
    model (host-side, float64).

    A1 = L' blkdiag_d(C_d^{-1}) L is the GP-prior quadratic expressed in
    whitened coordinates: t1 = z' A1 z. It is well-conditioned (eigenvalues
    bounded by the preconditioned curvature ratio), so evaluating it in
    float32 is safe — unlike the raw x' C^{-1} x form, whose ~1e8-magnitude
    term cancellation destroys float32 energies (measured: NUTS acceptance
    -> 0).

    Pass the clamped sqrt factors R = C^{-1/2}, S = K^{-1/2} whenever the
    sampler evaluates t1/t2 through them (predict() always does): then
    A1 = L'(R'R)L matches the centered target EXACTLY even when band
    truncation made the raw C^{-1} indefinite, and Lambda is PSD (see
    gauss_newton_precision).
    """
    N, D = model.mag_I, model.D
    obs_mask = (~np.isnan(model.X_obs_discret)).astype(np.float64)
    sigma = (
        model.sigma_sqs_init if sigma_sqs_init is None else sigma_sqs_init
    )
    J = pointwise_ode_jacobian(
        model.f_vec, model.I, model.Xhat_init, model.thetas_init
    )
    lam = gauss_newton_precision(
        model.C_d_invs, model.m_ds, model.K_d_invs, model.beta,
        obs_mask, sigma, J,
        C_inv_sqrts=C_inv_sqrts, K_inv_sqrts=K_inv_sqrts,
    )
    L, L_inv = factor_precision(lam)

    # blkdiag(C_inv) in X.ravel() (n*D+d) index order, then sandwich with L
    if C_inv_sqrts is not None:
        R = jnp.asarray(C_inv_sqrts)
        C_invs = jnp.einsum("dmn,dmM->dnM", R, R)
    else:
        C_invs = jnp.asarray(model.C_d_invs)
    Cb = jnp.zeros((N, D, N, D), C_invs.dtype)
    for d in range(D):
        Cb = Cb.at[:, d, :, d].set(C_invs[d])
    Cb = Cb.reshape(N * D, N * D)
    A1 = L.T @ (Cb @ L)
    A1 = (A1 + A1.T) / 2.0
    return L, L_inv, A1


# --- full-state whitening transforms (X block flattened row-major) ---------

def whiten_X_full(X, mu_ds, L_inv):
    """z (N, D) from X (N, D) using the full (ND, ND) factor."""
    xc = (X - mu_ds[None, :]).reshape(-1)
    return (L_inv @ xc).reshape(X.shape)


def unwhiten_Z_full(Z, mu_ds, L):
    """X (..., N, D) from z (..., N, D): x = mu + L z_flat."""
    shape = Z.shape
    zf = Z.reshape(shape[:-2] + (-1,))
    xc = jnp.einsum("ij,...j->...i", L, zf)
    return xc.reshape(shape) + mu_ds


# ---------------------------------------------------------------------------
# Banded Gauss-Newton whitening — the O(ND * b) large-grid path
# ---------------------------------------------------------------------------


def gauss_newton_precision_band(
    C_invs, m_ds, K_invs, beta, obs_mask, sigma_sqs, J, bw: int,
    comp_bandwidth: int | None = None,
    C_inv_sqrts=None, K_inv_sqrts=None,
):
    """Banded storage (2*bw+1, N*D) of the Gauss-Newton precision Lambda
    (same operator as gauss_newton_precision) without forming the dense
    (ND)^2 matrix — sparse products in O(ND * b^2) host flops.

    Index order matches X.ravel(): flat = n*D + d (interleaved), which is
    the ordering in which Lambda is banded (cross-component coupling is
    pointwise in time). ``comp_bandwidth`` bounds the per-component band of
    C^{-1}/m/K^{-1} read from the (band-truncated) dense inputs.

    When the f64 sqrt factors R = C^{-1/2}, S = K^{-1/2} are supplied, the
    precision is assembled from band(R)'band(R) / band(S)'band(S) — the
    EXACT PSD Gauss-Newton curvature of the banded sampling target, whose
    t1/t2 evaluate through those same band-truncated factors
    (posterior.to_banded_data). Without them, band truncation leaves the
    raw operators indefinite at dense-grid sizes and the resulting
    "whitened" geometry is garbage (measured: Lorenz N_I=1025/bandsize=100
    needed Cholesky jitter 2e5x the diagonal and froze the sampler).
    """
    import scipy.sparse as sp

    C_invs = np.asarray(C_invs, np.float64)
    m_ds = np.asarray(m_ds, np.float64)
    K_invs = np.asarray(K_invs, np.float64)
    J = np.asarray(J, np.float64)
    D, N = C_invs.shape[0], C_invs.shape[1]
    ND = N * D
    b = N - 1 if comp_bandwidth is None else int(min(comp_bandwidth, N - 1))

    def interleaved(mats):
        """Block-diag over components in interleaved flat order, banded."""
        rows, cols, vals = [], [], []
        for d in range(D):
            for k in range(-b, b + 1):
                diag = np.diagonal(mats[d], offset=k)
                if k >= 0:
                    r = np.arange(N - k)
                    c = r + k
                else:
                    c = np.arange(N + k)
                    r = c - k
                rows.append(r * D + d)
                cols.append(c * D + d)
                vals.append(diag)
        return sp.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(ND, ND),
        )

    if C_inv_sqrts is not None:
        Rb = interleaved(np.asarray(C_inv_sqrts, np.float64))
        C_term = Rb.T @ Rb
    else:
        C_term = interleaved(C_invs)
    if K_inv_sqrts is not None:
        Sb = interleaved(np.asarray(K_inv_sqrts, np.float64))
        K_term = Sb.T @ Sb
    else:
        K_term = interleaved(K_invs)

    # dr/dX = J_blockdiag - m_blockdiag  (see gauss_newton_precision docstring)
    J_sp = sp.bsr_matrix(
        (J, np.arange(N), np.arange(N + 1)), shape=(ND, ND)
    ).tocsr()
    R = J_sp - interleaved(m_ds)
    lam = (C_term + R.T @ K_term @ R) / float(beta)
    obs_diag = (
        np.asarray(obs_mask, np.float64) / np.asarray(sigma_sqs, np.float64)[None, :]
    ).ravel()
    lam = (lam + sp.diags(obs_diag)).tocsr()

    bw = int(min(bw, ND - 1))
    band = np.zeros((2 * bw + 1, ND), np.float64)
    for k in range(-bw, bw + 1):
        diag = lam.diagonal(k)
        if k >= 0:
            band[bw + k, : ND - k] = diag
        else:
            band[bw + k, -k:] = diag
    return band


def build_gn_cholesky_banded(
    model,
    sigma_sqs_init=None,
    bw_precision: int | None = None,
    C_inv_sqrts=None,
    K_inv_sqrts=None,
    at_X=None,
    at_thetas=None,
):
    """Banded Cholesky factor U of the Gauss-Newton precision Lambda = U'U
    from a fitted MAGI_v2 model (host-side float64). Returns (U_band, info).

    The sampler whitens with z = U (x - mu): the whitened curvature is
    U^{-T} Lambda U^{-1} = I IDENTICALLY. The unwhitening x = mu + U^{-1} z
    is applied per leapfrog as an exact O(ND*b) block-banded back
    substitution (ops.banded.block_banded_triangular_solve_upper) — NOT a
    band-truncated inverse: U^{-1}'s columns decay far too slowly to
    truncate (measured on Lorenz N_I=1025/bandsize=100: 92% of column norm
    beyond distance 303; the truncated whitener left eig(W'LamW) spread
    over 14 decades and rank-512 spectral repair still had cond ~2e3).

    Pass C_inv_sqrts/K_inv_sqrts (the f64 clamped factors the banded target
    evaluates t1/t2 through) so Lambda is the exact PSD GN curvature of
    that target; bw_precision then defaults to Lambda's NATURAL bandwidth
    4*D*bandsize (band(R)'band(R) doubles the per-component band, and the
    K sandwich doubles it again) — no truncation of Lambda at all, so the
    Cholesky needs no meaningful jitter. Without the factors, Lambda is
    assembled from the raw band-truncated operators, which are indefinite
    at dense-grid sizes (see gauss_newton_precision_band).
    """
    from magi_v2_tpu.ops.banded_host import banded_cholesky_upper

    N, D = model.mag_I, model.D
    bsize = model.BANDSIZE if model.BANDSIZE is not None else N - 1
    if bw_precision is None:
        if C_inv_sqrts is not None:
            bw_precision = min(N * D - 1, 4 * D * bsize)
        else:
            bw_precision = min(N * D - 1, D * (bsize + 1))
    obs_mask = (~np.isnan(model.X_obs_discret)).astype(np.float64)
    sigma = (
        model.sigma_sqs_init if sigma_sqs_init is None else sigma_sqs_init
    )
    # linearization anchor: the init point by default; pass at_X/at_thetas
    # to refresh the preconditioner at a later state (predict's
    # precond_refresh_steps) — any anchor yields an exact linear
    # reparameterization, only preconditioning quality varies
    X_anchor = model.Xhat_init if at_X is None else np.asarray(at_X)
    th_anchor = model.thetas_init if at_thetas is None else np.asarray(at_thetas)
    J = np.asarray(
        pointwise_ode_jacobian(
            model.f_vec, model.I, X_anchor, th_anchor
        ),
        np.float64,
    )
    lam_band = gauss_newton_precision_band(
        model.C_d_invs, model.m_ds, model.K_d_invs, model.beta,
        obs_mask, sigma, J, bw_precision, comp_bandwidth=bsize,
        C_inv_sqrts=C_inv_sqrts, K_inv_sqrts=K_inv_sqrts,
    )
    U_band, jitter = banded_cholesky_upper(lam_band)
    return U_band, {
        "jitter": jitter,
        "bw_precision": int(bw_precision),
    }


def whiten_X_banded(X, mu_ds, U_blocks):
    """z (N, D) from X (N, D): z = U @ (X - mu).ravel() — one banded
    matvec (U_blocks in banded_to_blocks_upper layout)."""
    from magi_v2_tpu.ops.banded import block_banded_matvec_upper

    X = jnp.asarray(X)
    xc = (X - jnp.asarray(mu_ds)[None, :]).reshape(-1)
    return block_banded_matvec_upper(U_blocks, xc).reshape(X.shape)


def unwhiten_Z_banded(Z, mu_ds, U_blocks, diag_inv=None):
    """X (..., N, D) from z (..., N, D): x = mu + U^{-1} z via the exact
    block-banded back substitution (U_blocks in banded_to_blocks_upper
    layout; diag_inv from ops.banded.banded_diag_tile_inverses, computed
    in f64 at setup — see its docstring for the precision trap)."""
    from magi_v2_tpu.ops.banded import block_banded_triangular_solve_upper

    shape = Z.shape
    zf = Z.reshape(shape[:-2] + (-1,))
    xc = block_banded_triangular_solve_upper(U_blocks, zf, diag_inv=diag_inv)
    return xc.reshape(shape) + mu_ds


def make_tempered_logp_grad_gn_banded(
    data, f_vec, U_blocks, N_I: int, D: int, D_thetas: int, diag_inv=None,
    ref=None, z0=None,
):
    """GN-whitened fused evaluation with every operator O(ND * b):
    x = mu + U^{-1} z (exact block-banded back substitution against the
    banded GN Cholesky factor U; whitened curvature = I identically),
    t1 = ||V (x - mu)||^2 via the per-component banded sqrt factors V of
    C^{-1} (float32-safe PSD sums — no cancellation), t2 via the banded
    K^{-1} factors inside log_posterior_given_t1. ``data`` must be a
    BandedPosteriorData with C_sqrt_blocks/K_sqrt_blocks present.

    With ``ref`` (posterior.RefPoint built from the band-truncated f64
    operators), t1/t2 evaluate RELATIVE to the reference point — required
    at dense-grid scale where the absolute energies reach ~1e7 and their
    float32 round-off alone collapses the adapted step size (measured:
    Lorenz N_I=1025 eps 1.5e-5 -> the f64-scale 1e-3 after this change)."""
    from magi_v2_tpu.ops.banded import (
        block_banded_matvec,
        block_banded_triangular_solve_upper,
    )
    from magi_v2_tpu.posterior import log_posterior_given_t1
    from magi_v2_tpu.sampler.magi_state import unflatten_state

    if data.C_sqrt_blocks is None or data.K_sqrt_blocks is None:
        raise ValueError(
            "banded GN whitening needs the banded sqrt factors; build the "
            "data via to_banded_data(..., C_inv_sqrts_f64=..., "
            "K_inv_sqrts_f64=...)"
        )

    if (ref is None) != (z0 is None):
        raise ValueError("ref and z0 must be supplied together")

    def lp(q, beta_temp):
        Z, sigma_pre, theta_pre = unflatten_state(q, N_I, D, D_thetas)
        if ref is None:
            xc_flat = block_banded_triangular_solve_upper(
                U_blocks, Z.reshape(-1), diag_inv=diag_inv
            )
            Xc = xc_flat.reshape(N_I, D)
            X = Xc + data.mu_ds[None, :]
            t1 = jnp.sum(block_banded_matvec(data.C_sqrt_blocks, Xc.T) ** 2)
            return log_posterior_given_t1(
                data, f_vec, X, sigma_pre, theta_pre, beta_temp, t1
            )
        # delta = U^{-1}(z - z0): the solve acts on the SMALL whitened
        # deviation, so delta is relatively accurate in f32; forming
        # x = U^{-1} z and subtracting x0 instead puts absolute x-noise
        # (kappa(U)*eps32*|x|) against the huge GP-prior gradient at x0
        delta = block_banded_triangular_solve_upper(
            U_blocks, Z.reshape(-1) - z0, diag_inv=diag_inv
        ).reshape(N_I, D)
        X = ref.x0 + delta
        Rd = block_banded_matvec(data.C_sqrt_blocks, delta.T)
        t1 = jnp.sum(Rd * (Rd + 2.0 * ref.a0))
        return log_posterior_given_t1(
            data, f_vec, X, sigma_pre, theta_pre, beta_temp, t1,
            ref=ref, delta=delta,
        )

    vag = jax.value_and_grad(lp, argnums=0)

    def logp_grad(q, beta_temp):
        return vag(q, beta_temp)

    return logp_grad


def make_tempered_logp_grad_gn_hybrid(
    data, f_vec, U_blocks, N_I: int, D: int, D_thetas: int, diag_inv=None,
    ref=None, z0=None,
):
    """Banded-GN whitened coordinates against the EXACT dense posterior —
    the hybrid large-grid mode (storage='hybrid').

    Coordinates are the banded mode's: z = U (x - mu) with U the banded
    GN Cholesky factor, unwhitened per leapfrog by the exact O(ND*b)
    block-banded back substitution. Energies are the dense mode's: t1/t2
    and the m-matvec go through the FULL factored operators
    (``data.C_inv_sqrts``/``K_inv_sqrts``, D batched N^2 matvecs per
    eval) — NO band truncation of the posterior at all.

    Why this mode exists (round-4 adjudication, DEVIATIONS.md #26,
    results/lorenz_joint_map_probe.json): at Lorenz N_I=1025/bandsize=100 the banded
    TARGET drops 63% of K^{-1}'s Frobenius mass and its theta mode sits
    ~(-16,-7,-11)% off the exact posterior's, which sits at truth. The
    truncation is a TARGET error; the truncated GN factor is only a
    PRECONDITIONER, whose band error costs step size, not correctness.
    Splitting the two lets the sampler keep the only whitening that is
    stable at dense-grid sizes while sampling the right distribution.
    Dense matvecs are affordable at these grid sizes; where block-banded
    overtakes dense on the GPU has not been measured.

    ``data`` must be the DENSE PosteriorData with C_inv_sqrts present.
    ``ref``/``z0`` (built from the SAME exact operators) are required at
    dense-grid scale for f32 (see make_tempered_logp_grad_gn_banded).
    """
    from magi_v2_tpu.ops.banded import block_banded_triangular_solve_upper
    from magi_v2_tpu.posterior import log_posterior_given_t1
    from magi_v2_tpu.sampler.magi_state import unflatten_state

    if data.C_inv_sqrts is None:
        raise ValueError(
            "hybrid mode needs the dense factored operators; build the "
            "data with C_inv_sqrts/K_inv_sqrts"
        )
    if (ref is None) != (z0 is None):
        raise ValueError("ref and z0 must be supplied together")

    def lp(q, beta_temp):
        Z, sigma_pre, theta_pre = unflatten_state(q, N_I, D, D_thetas)
        if ref is None:
            xc_flat = block_banded_triangular_solve_upper(
                U_blocks, Z.reshape(-1), diag_inv=diag_inv
            )
            Xc = xc_flat.reshape(N_I, D)
            X = Xc + data.mu_ds[None, :]
            Rx = jnp.einsum("dnm,dm->dn", data.C_inv_sqrts, Xc.T)
            t1 = jnp.sum(Rx ** 2)
            return log_posterior_given_t1(
                data, f_vec, X, sigma_pre, theta_pre, beta_temp, t1
            )
        # delta = U^{-1}(z - z0): solve on the SMALL whitened deviation
        # (see the banded builder for why x - x0 in f32 is not an option)
        delta = block_banded_triangular_solve_upper(
            U_blocks, Z.reshape(-1) - z0, diag_inv=diag_inv
        ).reshape(N_I, D)
        X = ref.x0 + delta
        Rd = jnp.einsum("dnm,dm->dn", data.C_inv_sqrts, delta.T)
        t1 = jnp.sum(Rd * (Rd + 2.0 * ref.a0))
        return log_posterior_given_t1(
            data, f_vec, X, sigma_pre, theta_pre, beta_temp, t1,
            ref=ref, delta=delta,
        )

    vag = jax.value_and_grad(lp, argnums=0)

    def logp_grad(q, beta_temp):
        return vag(q, beta_temp)

    return logp_grad


def make_tempered_logp_grad_gn(
    data, f_vec, L, A1, N_I: int, D: int, D_thetas: int, ref=None, z0=None
):
    """Fused evaluation in GN-whitened coordinates; t1 = z' A1 z (see
    build_gn_whitening for why this form is float32-safe).

    With ``ref`` (posterior.RefPoint), t1 is instead evaluated relative to
    the reference point through the factored form (needs data.C_inv_sqrts)
    and t2 relative inside log_posterior_given_t1 — the float32 answer at
    dense-grid energy magnitudes (see RefPoint)."""
    from magi_v2_tpu.posterior import log_posterior_given_t1
    from magi_v2_tpu.sampler.magi_state import unflatten_state

    if ref is not None and data.C_inv_sqrts is None:
        raise ValueError("relative t1 needs data.C_inv_sqrts")
    if (ref is None) != (z0 is None):
        raise ValueError("ref and z0 must be supplied together")

    def lp(q, beta_temp):
        Z, sigma_pre, theta_pre = unflatten_state(q, N_I, D, D_thetas)
        if ref is None:
            X = unwhiten_Z_full(Z, data.mu_ds, L)
            zf = Z.reshape(-1)
            t1 = zf @ (A1 @ zf)
            return log_posterior_given_t1(
                data, f_vec, X, sigma_pre, theta_pre, beta_temp, t1
            )
        # delta = L (z - z0): matvec of the SMALL whitened deviation (see
        # the banded builder for why x - x0 in f32 is not an option)
        delta = (L @ (Z.reshape(-1) - z0)).reshape(N_I, D)
        X = ref.x0 + delta
        Rd = jnp.einsum("dnm,dm->dn", data.C_inv_sqrts, delta.T)
        t1 = jnp.sum(Rd * (Rd + 2.0 * ref.a0))
        return log_posterior_given_t1(
            data, f_vec, X, sigma_pre, theta_pre, beta_temp, t1,
            ref=ref, delta=delta,
        )

    vag = jax.value_and_grad(lp, argnums=0)

    def logp_grad(q, beta_temp):
        return vag(q, beta_temp)

    return logp_grad
