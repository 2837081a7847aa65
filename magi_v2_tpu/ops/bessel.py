"""Differentiable modified Bessel function of the second kind K_nu(z) in JAX.

The reference library reaches K_nu through ``scipy.special.kvp`` on the host
(reference: magi_v2.py:2,787), which is neither jittable nor differentiable.
MAGI needs K_nu for real non-integer order (nu = 2.01) *inside* jitted,
autodiff'ed code: the GP-hyperparameter MLE differentiates the Matern Gram
matrix w.r.t. the lengthscale phi2, and gradients flow through
z = sqrt(2 nu) |s-t| / phi2.

Implementation: the classical two-regime algorithm (Temme 1975 power series
for z <= 2; Steed/Thompson-Barnett continued fraction CF2 for z > 2) computes
(K_mu, K_{mu+1}) for mu in (0, 1), then the standard upward recurrence
K_{v+1}(z) = K_{v-1}(z) + (2 v / z) K_v(z) climbs to higher orders. The order
``mu`` is a static Python float, so all Gamma-function constants are computed
at trace time with SciPy — no differentiability w.r.t. nu is needed (nu is a
fixed model constant; reference pins nu=2.01 at magi_v2.py:125).

Derivatives w.r.t. z use the identity dK_v/dz = -K_{v+1} + (v/z) K_v via a
``jax.custom_jvp`` whose tangent re-invokes the ladder with one extra order —
so the function is smoothly differentiable to any depth the program needs
(the MAGI kernel matrices need two z-derivatives).

Everything is fixed-iteration (lax.fori_loop with static bounds), static
shape, and vectorized over z — XLA friendly.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from scipy.special import gamma as _scipy_gamma

# Fixed iteration counts (validated against SciPy in tests/test_bessel.py).
_SERIES_ITERS = 40   # Temme series, z <= 2: term_i ~ (z^2/4)^i / i! -> < 1e-33 at i=40
_CF2_ITERS = 160     # Steed CF2, z > 2: slowest convergence just above z = 2

_EXP_UNDERFLOW_Z = 700.0  # beyond this exp(-z) underflows in f64; K_v is 0.


def _temme_series(z, mu: float):
    """(K_mu(z), K_{mu+1}(z)) for 0 < z <= 2, |mu| < 1, mu static."""
    dt = z.dtype
    # Static (trace-time) Gamma constants.
    gampl = 1.0 / _scipy_gamma(1.0 + mu)   # 1/Gamma(1+mu)
    gammi = 1.0 / _scipy_gamma(1.0 - mu)   # 1/Gamma(1-mu)
    gam1 = (gammi - gampl) / (2.0 * mu) if mu != 0.0 else 0.5772156649015329
    gam2 = 0.5 * (gammi + gampl)
    pimu = math.pi * mu
    fact = pimu / math.sin(pimu) if mu != 0.0 else 1.0
    nu2 = mu * mu

    d = -jnp.log(z / 2.0)
    e = mu * d
    # sinh(e)/e, safe at e -> 0.
    fact2 = jnp.where(jnp.abs(e) < 1e-30, 1.0, jnp.sinh(e) / jnp.where(e == 0, 1.0, e))
    ff0 = fact * (gam1 * jnp.cosh(e) + gam2 * fact2 * d)
    ee = jnp.exp(e)
    p0 = 0.5 * ee / gampl      # = 0.5 (z/2)^{-mu} Gamma(1+mu)
    q0 = 0.5 / (ee * gammi)    # = 0.5 (z/2)^{+mu} Gamma(1-mu)
    c0 = jnp.ones_like(z)
    dd = z * z / 4.0

    def body(i, carry):
        ff, p, q, c, s, s1 = carry
        fi = jnp.asarray(i, dt)
        ff = (fi * ff + p + q) / (fi * fi - nu2)
        c = c * dd / fi
        p = p / (fi - mu)
        q = q / (fi + mu)
        s = s + c * ff
        s1 = s1 + c * (p - fi * ff)
        return ff, p, q, c, s, s1

    _, _, _, _, s, s1 = jax.lax.fori_loop(
        1, _SERIES_ITERS + 1, body, (ff0, p0, q0, c0, ff0, p0)
    )
    k_mu = s
    k_mu1 = s1 * (2.0 / z)
    return k_mu, k_mu1


def _steed_cf2(z, mu: float):
    """(K_mu(z), K_{mu+1}(z)) for z > 2 via Steed's continued fraction CF2."""
    dt = z.dtype
    nu2 = mu * mu
    a1 = 0.25 - nu2

    b0 = 2.0 * (1.0 + z)
    d0 = 1.0 / b0
    h0 = d0
    delh0 = d0
    q1_0 = jnp.zeros_like(z)
    q2_0 = jnp.ones_like(z)
    q0 = jnp.full_like(z, a1)
    c0 = jnp.full_like(z, a1)
    a0 = jnp.full_like(z, -a1)
    s0 = 1.0 + q0 * delh0

    # Convergence freeze: once |q*delh| <= eps*|s| the carry stops updating.
    # Without this the auxiliary q1/q2 recurrence grows without bound and
    # overflows float32 (the fast sampling dtype) long before iteration 160.
    eps = jnp.finfo(dt).eps
    done0 = jnp.zeros_like(z, dtype=bool)

    def body(i, carry):
        b, d, h, delh, q1, q2, q, c, a, s, done = carry
        fi = jnp.asarray(i, dt)
        a_n = a - 2.0 * (fi - 1.0)
        c_n = -a_n * c / fi
        qnew = (q1 - b * q2) / a_n
        q1_n, q2_n = q2, qnew
        q_n = q + c_n * qnew
        b_n = b + 2.0
        d_n = 1.0 / (b_n + a_n * d)
        delh_n = (b_n * d_n - 1.0) * delh
        h_n = h + delh_n
        s_n = s + q_n * delh_n
        upd = lambda old, new: jnp.where(done, old, new)
        done_n = done | (jnp.abs(q_n * delh_n) <= eps * jnp.abs(s_n))
        return (
            upd(b, b_n), upd(d, d_n), upd(h, h_n), upd(delh, delh_n),
            upd(q1, q1_n), upd(q2, q2_n), upd(q, q_n), upd(c, c_n),
            upd(a, a_n), upd(s, s_n), done_n,
        )

    carry = (b0, d0, h0, delh0, q1_0, q2_0, q0, c0, a0, s0, done0)
    out = jax.lax.fori_loop(2, _CF2_ITERS + 2, body, carry)
    h, s = out[2], out[9]
    h = a1 * h

    zc = jnp.minimum(z, _EXP_UNDERFLOW_Z)
    k_mu = jnp.sqrt(jnp.pi / (2.0 * z)) * jnp.exp(-zc) / s
    k_mu = jnp.where(z > _EXP_UNDERFLOW_Z, 0.0, k_mu)
    k_mu1 = k_mu * (mu + z + 0.5 - h) / z
    return k_mu, k_mu1


def _kv_ladder_raw(z, mu: float, n: int):
    """K_{mu+k}(z) for k = 0..n-1, stacked on a new leading axis.

    mu in (0, 1) and n are static. z > 0 elementwise (clamped internally).
    """
    z = jnp.asarray(z)
    dt = z.dtype
    # Clamp so the inactive jnp.where branch never produces NaN/Inf.
    z_safe = jnp.maximum(z, jnp.asarray(1e-300 if dt == jnp.float64 else 1e-30, dt))
    z_ser = jnp.minimum(z_safe, 2.0)
    z_cf = jnp.maximum(z_safe, 2.0)

    ks_mu, ks_mu1 = _temme_series(z_ser, mu)
    kc_mu, kc_mu1 = _steed_cf2(z_cf, mu)
    use_series = z_safe <= 2.0
    k0 = jnp.where(use_series, ks_mu, kc_mu)
    k1 = jnp.where(use_series, ks_mu1, kc_mu1)

    if n == 1:
        return k0[None]
    out = [k0, k1]
    for k in range(1, n - 1):
        # K_{mu+k+1} = K_{mu+k-1} + 2 (mu+k) / z * K_{mu+k}
        out.append(out[k - 1] + (2.0 * (mu + k) / z_safe) * out[k])
    return jnp.stack(out, axis=0)


@partial(jax.custom_jvp, nondiff_argnums=(1, 2))
def kv_ladder(z, mu: float, n: int):
    """Differentiable ladder of modified Bessel K values.

    Returns array of shape ``(n,) + z.shape`` with entries K_{mu+k}(z),
    k = 0..n-1. ``mu`` must satisfy 0 < mu < 1 and be a static Python float.
    """
    return _kv_ladder_raw(z, mu, n)


@kv_ladder.defjvp
def _kv_ladder_jvp(mu, n, primals, tangents):
    (z,) = primals
    (zdot,) = tangents
    z = jnp.asarray(z)
    kk = kv_ladder(z, mu, n + 1)  # recursively differentiable
    out = kk[:n]
    orders = (mu + jnp.arange(n, dtype=kk.dtype)).reshape((n,) + (1,) * z.ndim)
    z_safe = jnp.maximum(z, jnp.asarray(1e-300 if z.dtype == jnp.float64 else 1e-30, z.dtype))
    # dK_v/dz = -K_{v+1} + (v/z) K_v
    dk = -kk[1 : n + 1] + (orders / z_safe) * kk[:n]
    return out, dk * zdot


def _split_order(v: float):
    """Split static order v >= 0 into (mu, k) with v = mu + k, 0 < mu < 1.

    Orders very close to an integer are nudged (the MAGI method requires
    non-integer nu anyway; reference uses 2.01).
    """
    k = int(math.floor(v))
    mu = v - k
    if mu < 1e-8:
        mu = 1e-8
    if mu > 1 - 1e-8:
        mu = 1 - 1e-8
    return mu, k


def kv(v: float, z):
    """K_v(z) for static real order v >= 0, differentiable w.r.t. z."""
    mu, k = _split_order(v)
    return kv_ladder(z, mu, k + 1)[k]


def kvp(v: float, z, n: int = 1):
    """n-th derivative of K_v w.r.t. z (mirror of scipy.special.kvp).

    Uses d/dz K_v = -(K_{v-1} + K_{v+1})/2 applied n times. Requires
    v - n >= 0 so all needed orders sit on the same ladder (the MAGI kernel
    builder uses v = 2.01, n <= 2; reference magi_v2.py:787).
    """
    if n == 0:
        return kv(v, z)
    mu, k = _split_order(v)
    if k < n:
        raise NotImplementedError(
            "kvp requires floor(v) >= n so all orders sit on one ladder"
        )
    ladder = kv_ladder(z, mu, k + n + 1)  # orders mu .. mu+k+n

    # Binomial expansion: K_v^{(n)} = (-1/2)^n sum_j C(n,j) K_{v-n+2j}
    coef = (-0.5) ** n
    acc = 0.0
    for j in range(n + 1):
        acc = acc + math.comb(n, j) * ladder[k - n + 2 * j]
    return coef * acc
