"""The fused, tempered MAGI log-posterior — the hot function of the library.

Implements the 4-term unnormalized log-posterior of reference
magi_v2.py:308-348 (notation of SURVEY.md §0):

    log p ∝ beta_temp * [ -1/2 ( (1/beta)(t1 + t2) + t3 + t4 )
                          + logJac(sigma^2) + logJac(theta) ]

    t1 = sum_d ||x_d(I) - mu_d||^2_{C_d^{-1}}          GP prior
    t2 = sum_d ||f_d(I,X,theta) - m_d (x_d - mu_d)||^2_{K_d^{-1}}
    t3 = sum_d N_d log(2 pi sigma_d^2)
    t4 = sum_d ||x_d(tau_d) - y_d(tau_d)||^2 / sigma_d^2

sigma^2 and theta are sampled in unconstrained space through softplus
(+ lower bound sigma^2_LB for sigma^2) with change-of-variables Jacobians
(magi_v2.py:318-323).

Accelerator design: t1/t2 are batched (D, N, N) @ (D, N) contractions via
einsum — XLA lowers these to batched GEMMs, fuses the elementwise
epilogue, and the whole value+gradient is ONE jitted function (the
reference pays a TF-op-graph walk per NUTS leapfrog; here each leapfrog is
a single fused XLA computation). vmap over a leading chains axis gives the
multi-chain sampler for free.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class PosteriorData(NamedTuple):
    """Static (per-fit) arrays consumed by the log-posterior.

    All fields are JAX arrays; the tuple is a pytree so it can be closed
    over, donated, or sharded freely.
    """

    I: jax.Array            # (N_I, 1) discretization grid
    C_invs: jax.Array       # (D, N_I, N_I) inverse Gram matrices
    m_ds: jax.Array         # (D, N_I, N_I) conditioning matrices 'C C^{-1}
    K_invs: jax.Array       # (D, N_I, N_I) inverse conditional deriv covs
    mu_ds: jax.Array        # (D,) GP prior means
    beta: jax.Array         # scalar prior temper D*N_I / sum(N_d)
    N_ds: jax.Array         # (D,) per-component observation counts
    not_nan_idxs: jax.Array  # (M,) flat indices of observed entries
    not_nan_cols: jax.Array  # (M,) component id per observed entry
    y_observed: jax.Array   # (M,) observed values
    sigma_sqs_LB: jax.Array  # (D,) lower bound on sigma^2
    # Optional factored precisions R = C^{-1/2}, S = K^{-1/2} (D, N, N):
    # when present, quadratic forms are evaluated as ||R x||^2 / ||S r||^2 —
    # identical math, but float32-safe (the raw x\'Ax form sums ~1e8-magnitude
    # cancelling terms and destroys f32 energies; measured NUTS acceptance
    # -> 0 in float32). Factors must be computed in float64 at setup.
    C_inv_sqrts: jax.Array = None
    K_inv_sqrts: jax.Array = None


class RefPoint(NamedTuple):
    """Zero-point for RELATIVE energy evaluation (float32 safety at scale).

    At dense grids the absolute log-posterior magnitude reaches ~1e7
    (measured on Lorenz N_I=1025: the GP-prior quadratic of the init
    trajectory dominates), so float32 round-off of the SUMS injects O(10)
    energy noise (std(lp32-lp64) = 12.6 measured) and dual averaging
    collapses the step size ~100x below the f64 value. MCMC only needs the
    log-posterior up to a constant: with this f64-precomputed reference
    point, the big quadratics evaluate as exact differences

        t1 - t1(x0)        = sum Rd * (Rd + 2 a0),   Rd = R (x - x0)
        t2 - t2(x0,theta0) = sum Ds * (Ds + 2 s0),
              Ds = S dr,  dr = (f(x,theta) - f0) - m (x - x0)

    whose float32 error scales with the energy VARIATION, not the total.
    All arrays must be computed with EXACTLY the operators (band-truncated
    where applicable) the sampler evaluates with, in float64, then cast.
    """

    x0: jax.Array    # (N, D)  reference trajectories (the smoothed init)
    a0: jax.Array    # (D, N)  R (x0 - mu)
    f0: jax.Array    # (D, N)  f(I, x0, theta0)^T
    mx0: jax.Array   # (D, N)  m (x0 - mu)
    s0: jax.Array    # (D, N)  S (f0 - mx0)


def make_ref_point(I, x0, mu_ds, thetas0, f_vec, R64, S64, m64, dtype):
    """Build a RefPoint in float64 (see RefPoint) and cast to ``dtype``.

    R64/S64/m64 must be the float64 twins of the operators the sampler's
    data actually contains (band-truncated for the banded storage mode) —
    otherwise the relative identities do not hold exactly.
    """
    x0 = np.asarray(x0, np.float64)
    R64 = np.asarray(R64, np.float64)
    S64 = np.asarray(S64, np.float64)
    m64 = np.asarray(m64, np.float64)
    xc = (x0 - np.asarray(mu_ds, np.float64)[None, :]).T          # (D, N)
    a0 = np.einsum("dnm,dm->dn", R64, xc)
    f0 = np.asarray(
        f_vec(jnp.asarray(I), jnp.asarray(x0), jnp.asarray(np.asarray(thetas0, np.float64))),
        np.float64,
    ).T
    mx0 = np.einsum("dnm,dm->dn", m64, xc)
    s0 = np.einsum("dnm,dm->dn", S64, f0 - mx0)
    asd = lambda a: jnp.asarray(a, dtype)
    return RefPoint(x0=asd(x0), a0=asd(a0), f0=asd(f0), mx0=asd(mx0),
                    s0=asd(s0))


def make_posterior_data(
    I, C_invs, m_ds, K_invs, mu_ds, beta, obs_index, sigma_sqs_LB, dtype,
    C_inv_sqrts=None, K_inv_sqrts=None,
) -> PosteriorData:
    """Assemble PosteriorData from host arrays (obs_index: ObservationIndex)."""
    asd = lambda x: jnp.asarray(np.asarray(x), dtype=dtype)
    return PosteriorData(
        I=asd(I),
        C_invs=asd(C_invs),
        m_ds=asd(m_ds),
        K_invs=asd(K_invs),
        mu_ds=asd(mu_ds),
        beta=asd(beta),
        N_ds=asd(obs_index.N_ds),
        not_nan_idxs=jnp.asarray(obs_index.not_nan_idxs, dtype=jnp.int32),
        not_nan_cols=jnp.asarray(obs_index.not_nan_cols, dtype=jnp.int32),
        y_observed=asd(obs_index.y_observed),
        sigma_sqs_LB=asd(sigma_sqs_LB),
        C_inv_sqrts=None if C_inv_sqrts is None else asd(C_inv_sqrts),
        K_inv_sqrts=None if K_inv_sqrts is None else asd(K_inv_sqrts),
    )


class BandedPosteriorData(NamedTuple):
    """PosteriorData variant with precision operators in BLOCK-banded
    storage (D, nb, nw, 128, 128) — O(N_I*b) batched tile GEMMs instead of
    O(N_I^2) (ops/banded.py; the reference's bandsize option keeps banded
    matrices dense, magi_v2.py:271-274)."""

    I: jax.Array
    C_blocks: jax.Array     # (D, nb, nw, T, T)
    m_blocks: jax.Array
    K_blocks: jax.Array
    mu_ds: jax.Array
    beta: jax.Array
    N_ds: jax.Array
    not_nan_idxs: jax.Array
    not_nan_cols: jax.Array
    y_observed: jax.Array
    sigma_sqs_LB: jax.Array
    # Optional banded Cholesky factors V, U with C^{-1} ~= V'V, K^{-1} ~= U'U
    # (upper-triangular, same block-banded storage). When present, t1/t2
    # evaluate as ||V x||^2 / ||U r||^2 — float32-safe PSD sums, the banded
    # analog of the dense path's C_inv_sqrts/K_inv_sqrts (the raw x'Ax forms
    # cancel ~1e8-magnitude terms and destroy f32 energies).
    C_sqrt_blocks: jax.Array = None
    K_sqrt_blocks: jax.Array = None


def to_banded_data(
    data: PosteriorData,
    bandwidth: int,
    C_inv_sqrts_f64=None,
    K_inv_sqrts_f64=None,
) -> BandedPosteriorData:
    """Convert dense PosteriorData to block-banded storage, half-bandwidth b.

    When the float64 symmetric PSD square roots R = C^{-1/2}, S = K^{-1/2}
    (from ops.linalg.sym_sqrt of the band-truncated operators — negative
    eigenvalues clamped, exactly the dense mode's semantics) are supplied,
    their band truncations are stored so quadratic forms evaluate in
    factored float32-safe form ||band(R) x||^2. Banded Cholesky of the
    band-truncated operators themselves is NOT viable: truncation leaves
    them severely indefinite at dense-grid sizes (measured: Lorenz
    N_I=1025, bandsize=100 needs jitter > diag scale), whereas clamping
    matches what the dense path already does.
    """
    from magi_v2_tpu.ops.banded import banded_to_blocks, dense_to_banded

    to_blocks = lambda A: banded_to_blocks(dense_to_banded(A, bandwidth))

    def factor_blocks(S_f64):
        from magi_v2_tpu.ops.banded_host import dense_to_banded_np

        bands = np.stack(
            [
                dense_to_banded_np(comp, bandwidth)
                for comp in np.asarray(S_f64, np.float64)
            ]
        )
        return banded_to_blocks(jnp.asarray(bands, data.I.dtype))

    return BandedPosteriorData(
        I=data.I,
        C_blocks=to_blocks(data.C_invs),
        m_blocks=to_blocks(data.m_ds),
        K_blocks=to_blocks(data.K_invs),
        mu_ds=data.mu_ds,
        beta=data.beta,
        N_ds=data.N_ds,
        not_nan_idxs=data.not_nan_idxs,
        not_nan_cols=data.not_nan_cols,
        y_observed=data.y_observed,
        sigma_sqs_LB=data.sigma_sqs_LB,
        C_sqrt_blocks=(
            None if C_inv_sqrts_f64 is None else factor_blocks(C_inv_sqrts_f64)
        ),
        K_sqrt_blocks=(
            None if K_inv_sqrts_f64 is None else factor_blocks(K_inv_sqrts_f64)
        ),
    )


def softplus(x):
    return jax.nn.softplus(x)


def softplus_inverse(y):
    """Inverse of softplus: log(exp(y) - 1), stable for small and large y.

    Mirrors the reference's initial-state bijection (magi_v2.py:374-380).
    """
    y = jnp.asarray(y)
    # log(e^y - 1) = y + log(1 - e^-y) = y + log(-expm1(-y))
    return y + jnp.log(-jnp.expm1(-y))


def log_posterior_given_t1(
    data: PosteriorData,
    f_vec: Callable,
    X: jax.Array,
    sigma_sqs_pre: jax.Array,
    thetas_pre: jax.Array,
    beta_temp: jax.Array,
    t1: jax.Array,
    ref: RefPoint = None,
    delta=None,
) -> jax.Array:
    """Tempered log-posterior with the GP-prior quadratic t1 supplied.

    Whitened samplers compute t1 natively in their own coordinates: the raw
    x' C^{-1} x form sums ~1e8-magnitude terms with massive cancellation,
    which destroys float32 energies (measured: NUTS acceptance -> 0);
    z-space forms are well-conditioned.

    With ``ref``, t2 is evaluated RELATIVE to the reference point (see
    RefPoint — the caller must then supply a relative t1 as well); the
    result differs from the absolute log-posterior by a constant, which
    MCMC never sees. ``delta`` (N, D) optionally supplies x - x0 computed
    accurately in the caller's own coordinates (e.g. delta = U^{-1}(z-z0)):
    the float32 subtraction X - x0 loses all relative accuracy when the
    deviation is small against |x| ~ 30, and the resulting absolute x-noise
    couples to the large GP-prior gradient at the reference point.
    """
    sigma_sqs = softplus(sigma_sqs_pre) + data.sigma_sqs_LB
    thetas = softplus(thetas_pre)
    log_jac_sigma = jnp.sum(jax.nn.log_sigmoid(sigma_sqs_pre))
    log_jac_theta = jnp.sum(jax.nn.log_sigmoid(thetas_pre))

    beta_temp = jax.lax.stop_gradient(beta_temp)
    X_cent = (X - data.mu_ds[None, :]).T

    banded = isinstance(data, BandedPosteriorData)
    if banded:
        from magi_v2_tpu.ops.banded import block_banded_matvec

    f_vals = f_vec(data.I, X, thetas).T
    if ref is not None:
        # relative form: dr = (f - f0) - m (x - x0); Ds = S dr;
        # t2_rel = sum Ds (Ds + 2 s0)  [== t2 - t2(ref), exactly]
        delta = (X - ref.x0).T if delta is None else delta.T
        if banded:
            if data.K_sqrt_blocks is None:
                raise ValueError("relative t2 needs the banded sqrt factors")
            dr = (f_vals - ref.f0) - block_banded_matvec(
                data.m_blocks, delta
            )
            Ds = block_banded_matvec(data.K_sqrt_blocks, dr)
        else:
            if data.K_inv_sqrts is None:
                raise ValueError("relative t2 needs K_inv_sqrts")
            dr = (f_vals - ref.f0) - jnp.einsum(
                "dnm,dm->dn", data.m_ds, delta
            )
            Ds = jnp.einsum("dnm,dm->dn", data.K_inv_sqrts, dr)
        t2 = jnp.sum(Ds * (Ds + 2.0 * ref.s0))
    elif banded:
        resid = f_vals - block_banded_matvec(data.m_blocks, X_cent)
        if data.K_sqrt_blocks is not None:
            t2 = jnp.sum(block_banded_matvec(data.K_sqrt_blocks, resid) ** 2)
        else:
            t2 = jnp.sum(resid * block_banded_matvec(data.K_blocks, resid))
    else:
        resid = f_vals - jnp.einsum("dnm,dm->dn", data.m_ds, X_cent)
        if data.K_inv_sqrts is not None:
            t2 = jnp.sum(jnp.einsum("dnm,dm->dn", data.K_inv_sqrts, resid) ** 2)
        else:
            t2 = jnp.einsum("dn,dnm,dm->", resid, data.K_invs, resid)

    t3 = jnp.sum(data.N_ds * jnp.log(2.0 * jnp.pi * sigma_sqs))

    X_obs = jnp.take(X.reshape(-1), data.not_nan_idxs)
    inv_var = jnp.take(1.0 / sigma_sqs, data.not_nan_cols)
    t4 = jnp.sum((X_obs - data.y_observed) ** 2 * inv_var)

    return beta_temp * (
        -0.5 * ((t1 + t2) / data.beta + t3 + t4) + log_jac_sigma + log_jac_theta
    )


def log_posterior(
    data: PosteriorData,
    f_vec: Callable,
    X: jax.Array,            # (N_I, D) latent trajectories
    sigma_sqs_pre: jax.Array,  # (D,) unconstrained noise variances
    thetas_pre: jax.Array,   # (D_thetas,) unconstrained ODE parameters
    beta_temp: jax.Array,    # scalar annealing temperature
) -> jax.Array:
    """The fused tempered log-posterior (reference magi_v2.py:308-348)."""
    # softplus bijections + change-of-variables log-Jacobians
    # (log-Jacobian of softplus is log_sigmoid: d/dx log(1+e^x) = sigmoid(x))
    sigma_sqs = softplus(sigma_sqs_pre) + data.sigma_sqs_LB
    thetas = softplus(thetas_pre)
    log_jac_sigma = jnp.sum(jax.nn.log_sigmoid(sigma_sqs_pre))
    log_jac_theta = jnp.sum(jax.nn.log_sigmoid(thetas_pre))

    beta_temp = jax.lax.stop_gradient(beta_temp)

    # (D, N_I) centered trajectories
    X_cent = (X - data.mu_ds[None, :]).T

    if isinstance(data, BandedPosteriorData):
        from magi_v2_tpu.ops.banded import block_banded_matvec

        # O(N_I*b) block-banded path (batched tile GEMMs); factored
        # ||V x||^2 / ||U r||^2 forms when the banded Cholesky factors are
        # present (float32-safe — see BandedPosteriorData)
        if data.C_sqrt_blocks is not None:
            t1 = jnp.sum(block_banded_matvec(data.C_sqrt_blocks, X_cent) ** 2)
        else:
            t1 = jnp.sum(X_cent * block_banded_matvec(data.C_blocks, X_cent))
        f_vals = f_vec(data.I, X, thetas).T            # (D, N_I)
        resid = f_vals - block_banded_matvec(data.m_blocks, X_cent)
        if data.K_sqrt_blocks is not None:
            t2 = jnp.sum(block_banded_matvec(data.K_sqrt_blocks, resid) ** 2)
        else:
            t2 = jnp.sum(resid * block_banded_matvec(data.K_blocks, resid))
    else:
        # t1: GP prior quadratic forms — batched matvecs, in factored
        # ||R x||^2 form when sqrt factors are present (float32-safe)
        if data.C_inv_sqrts is not None:
            t1 = jnp.sum(jnp.einsum("dnm,dm->dn", data.C_inv_sqrts, X_cent) ** 2)
        else:
            t1 = jnp.einsum("dn,dnm,dm->", X_cent, data.C_invs, X_cent)

        # t2: manifold constraint
        f_vals = f_vec(data.I, X, thetas).T            # (D, N_I)
        resid = f_vals - jnp.einsum("dnm,dm->dn", data.m_ds, X_cent)
        if data.K_inv_sqrts is not None:
            t2 = jnp.sum(jnp.einsum("dnm,dm->dn", data.K_inv_sqrts, resid) ** 2)
        else:
            t2 = jnp.einsum("dn,dnm,dm->", resid, data.K_invs, resid)

    # t3: noise normalizer
    t3 = jnp.sum(data.N_ds * jnp.log(2.0 * jnp.pi * sigma_sqs))

    # t4: observation likelihood on observed entries only (static gather)
    X_obs = jnp.take(X.reshape(-1), data.not_nan_idxs)
    inv_var = jnp.take(1.0 / sigma_sqs, data.not_nan_cols)
    t4 = jnp.sum((X_obs - data.y_observed) ** 2 * inv_var)

    return beta_temp * (
        -0.5 * ((t1 + t2) / data.beta + t3 + t4) + log_jac_sigma + log_jac_theta
    )


def make_log_posterior(data: PosteriorData, f_vec: Callable):
    """Close over the static data; returns lp(X, sigma_pre, theta_pre, beta_temp)."""

    def lp(X, sigma_sqs_pre, thetas_pre, beta_temp):
        return log_posterior(data, f_vec, X, sigma_sqs_pre, thetas_pre, beta_temp)

    return lp


def make_value_and_grad(data: PosteriorData, f_vec: Callable):
    """Fused log-posterior + gradient w.r.t. (X, sigma_pre, theta_pre).

    One XLA computation per call — this is the BASELINE.json north-star
    metric ("fused log-posterior+grad evals/sec per chip").
    """
    lp = make_log_posterior(data, f_vec)
    return jax.value_and_grad(lp, argnums=(0, 1, 2))
