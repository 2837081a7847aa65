"""Mass-matrix abstraction: diagonal, or diagonal + dense tail block.

The reference samples with an identity mass matrix (tfp NoUTurnSampler
default, magi_v2.py:361-364); this library's warmup adapts a diagonal from
pooled Welford moments (sampler/run.py). A diagonal fixes per-coordinate
scales but cannot rotate correlated ridges — and the (sigma_sqs_pre,
thetas_pre) tail block of the MAGI state is strongly correlated for most
systems (SEIR beta/gamma are ridge-coupled through R0), which is what
forces long HMC trajectories (measured: theta ESS_min 829 at L=64 vs
18038 at L=192 on the SEIR bench, results/seir_dense_mass_probe.json).

``TailDenseMass`` keeps the O(N_I*D) trajectory block diagonal (anything
else would defeat the banded large-grid scaling) and carries a dense
inverse-mass block over the LAST k coordinates of the flat state — the
low-dimensional (sigma_pre, theta_pre) tail, k = D + D_thetas (or just
D_thetas when sigma is pinned). The k x k operators cost nothing next to a
leapfrog's O(D * N_I * b) posterior gradient.

All sampler kernels consume the mass only through the three helpers below,
which also accept a plain (dim,) array — the original diagonal path is
bit-identical when no tail block is configured.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class TailDenseMass(NamedTuple):
    """Inverse-mass diagonal + dense tail block over the last k coords.

    diag: (dim,) inverse-mass diagonal. The last k entries are the tail
        block's MARGINAL inverse masses — kept for reporting/diagnostics
        only; dynamics use ``tail_inv`` for those coordinates.
    tail_inv: (k, k) symmetric inverse mass of the tail block — the
        (regularized) posterior covariance estimate, Stan's dense metric.
    tail_msqrt: (k, k) matrix A with A @ A.T = tail mass M = tail_inv^{-1},
        used to sample momenta p_tail = A z.
    """

    diag: jax.Array
    tail_inv: jax.Array
    tail_msqrt: jax.Array

    @property
    def k(self) -> int:
        return self.tail_inv.shape[-1]


def identity_mass(dim: int, dense_tail_size: int, dtype):
    """Identity inverse mass: plain (dim,) ones when no tail block is
    requested (the existing diagonal path), else a TailDenseMass with
    identity blocks (same dynamics, different pytree structure — the
    structure must be fixed from step 0 so lax.cond/scan carries match)."""
    diag = jnp.ones(dim, dtype)
    if dense_tail_size <= 0:
        return diag
    k = int(dense_tail_size)
    if k > dim:
        raise ValueError(f"dense_tail_size {k} exceeds state dim {dim}")
    eye = jnp.eye(k, dtype=dtype)
    return TailDenseMass(diag=diag, tail_inv=eye, tail_msqrt=eye)


def mass_from_moments(var, tail_cov):
    """Build a TailDenseMass from the Welford window's pooled moments.

    var: (dim,) regularized variances (the diagonal estimate).
    tail_cov: (k, k) regularized covariance of the last k coordinates
    (k may equal dim — the full dense metric).

    The factorization runs in the sampling dtype but through the
    CORRELATION matrix: Sigma = S R S with S = diag(sd). Marginal scales
    in the sampling coordinates span ~1e-4..1e1 (squared: ~1e10 dynamic
    range), which would push a direct f32 Cholesky of Sigma past its
    conditioning budget; R's condition number is only the correlation
    structure's, and the scales re-enter exactly through S.
    """
    k = tail_cov.shape[-1]
    diag = var.at[-k:].set(jnp.diag(tail_cov))
    sd = jnp.sqrt(jnp.diag(tail_cov))
    R = tail_cov / jnp.outer(sd, sd)
    L = jnp.linalg.cholesky(R)                 # R = L L^T
    eye = jnp.eye(k, dtype=tail_cov.dtype)
    L_inv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    # M = Sigma^{-1} = S^{-1} R^{-1} S^{-1}; A = S^{-1} L^{-T} gives
    # A A^T = S^{-1} L^{-T} L^{-1} S^{-1} = M
    msqrt = L_inv.T / sd[:, None]
    return TailDenseMass(diag=diag, tail_inv=tail_cov, tail_msqrt=msqrt)


def mass_vel(inv_mass, p):
    """Velocity v = M^{-1} p. Broadcasts over leading axes of ``p``."""
    if not isinstance(inv_mass, TailDenseMass):
        return p * inv_mass
    k = inv_mass.k
    head = p[..., :-k] * inv_mass.diag[:-k]
    tail = p[..., -k:] @ inv_mass.tail_inv
    return jnp.concatenate([head, tail], axis=-1)


def mass_kinetic(inv_mass, p):
    """0.5 * p^T M^{-1} p (sum over the last axis)."""
    return 0.5 * jnp.sum(p * mass_vel(inv_mass, p), axis=-1)


def mass_sample_momentum(inv_mass, key, shape, dtype):
    """Draw p ~ N(0, M). ``shape`` must end in (dim,)."""
    z = jax.random.normal(key, shape, dtype)
    if not isinstance(inv_mass, TailDenseMass):
        return z / jnp.sqrt(inv_mass)
    k = inv_mass.k
    head = z[..., :-k] / jnp.sqrt(inv_mass.diag[:-k])
    tail = z[..., -k:] @ inv_mass.tail_msqrt.T
    return jnp.concatenate([head, tail], axis=-1)


def mass_diag(inv_mass):
    """(dim,) inverse-mass diagonal for reporting (marginals for the tail)."""
    if isinstance(inv_mass, TailDenseMass):
        return inv_mass.diag
    return inv_mass


def mass_tail_inv(inv_mass):
    """(k, k) tail inverse-mass block, or None for plain diagonals."""
    if isinstance(inv_mass, TailDenseMass):
        return inv_mass.tail_inv
    return None
