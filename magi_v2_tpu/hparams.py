"""GP hyperparameter fitting: Matern (phi1, phi2) + noise sigma^2 MLE with
Fourier-informed priors.

Re-implements reference _fit_kernel_hparams (magi_v2.py:538-691) as jitted
device code:

- The Fourier prior (magi_v2.py:549-565) is host-side NumPy (one FFT per
  component at setup time).
- The MAP objective — per-component GP marginal likelihood with constant
  mean, observation noise, and TruncatedNormal priors (magi_v2.py:574-628) —
  is a single jitted function: the Matern Gram matrices come from our
  differentiable Bessel ladder, the D marginal likelihoods are a *batched*
  Cholesky via vmap, and the 1000 Adam steps run inside
  one lax.scan (the reference crosses the Python<->XLA boundary once per
  step, magi_v2.py:677-678).
- Parameters are optimized in softplus pre-space exactly like the
  reference's TransformedVariables (magi_v2.py:631-642).

Prior-scale note: the reference inflates every prior scale by sqrt(D)
because its broadcasted JointDistribution counts each prior D times
(magi_v2.py:603-607,614-627). Summing each prior once with the *unscaled*
sd — as done here — yields identical gradients, hence an identical MAP.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from magi_v2_tpu.ops.kernels import matern_gram, matern_gram_uniform, uniform_spacing
from magi_v2_tpu.posterior import softplus, softplus_inverse


class FourierPrior(NamedTuple):
    mu_ds: np.ndarray     # (D,) per-component data means (GP prior mean)
    mu_phi2s: np.ndarray  # (D,) Fourier-informed prior mean for phi2
    sd_phi2s: np.ndarray  # (D,) prior sd for phi2


def fourier_prior(X_filled: np.ndarray, t_range: float = 1.0) -> FourierPrior:
    """Spectral-mass-weighted mean frequency -> phi2 prior (magi_v2.py:549-565).

    Deviation by intent (DEVIATIONS.md): the reference computes the prior
    mean as 0.5/freq with freq in CYCLES PER RECORD — i.e. in units of the
    record length — and its sd as (1 - mu)/3, which is only sensible when
    the time span is O(1) (negative for mu > 1!). On the Hes1 workload
    (t in [0, 240] min, ~120 min oscillation) the index-unit prior pins
    phi2 ~ 0.2 min, 40x below the observation spacing: the GP becomes
    white noise, the conditional-derivative operators carry no
    information, and the theta posterior opens up along parameter ridges
    (measured: b, c drift to 3.5x truth with the combination b*mean(M/P)-c
    preserved, even from oracle inits). The profile likelihood prefers
    phi2 ~ 25-40 min by ~28 nats but loses to thousands of nats of prior.
    The repair is RESOLUTION-GATED to stay reference-compatible on the
    reference's own workloads: the reference value 0.5/freq (read as
    absolute time) is kept — with its (1 - mu)/3 sd where that is
    positive — whenever it is resolvable by the data, i.e. at least twice
    the mean sampling interval. Only when the reference value is
    SUB-RESOLUTION (the Hes1 failure: a lengthscale the grid cannot even
    represent) does the prior switch to physical units, a quarter of the
    spectral-mean wavelength (0.25 * t_range / freq) with a 50%-relative
    sd. Measured motivations for the gate: unconditionally converting to
    time units doubles the SEIR lengthscales (kappa(C) 1.5e8 -> 2.8e9),
    which tripled bench R-hat and introduced 2-7% divergence rates, while
    the reference operating point reproduces the published recovery with
    zero divergences; on Hes1 the corrected value 0.25*240/2.4 = 25 min
    sits inside the likelihood-preferred 25-40 band (the reference value
    0.21 min loses ~28 nats of profile likelihood and opens theta
    ridges).
    """
    X_filled = np.asarray(X_filled)
    t_range = float(t_range) if t_range else 1.0
    n = X_filled.shape[0]
    spacing = t_range / max(n - 1, 1)
    mu_ds, mu_phi2s, sd_phi2s = [], [], []
    for d in range(X_filled.shape[1]):
        z = np.fft.fft(X_filled[:, d])
        zmod = np.abs(z)
        zmod_eff = zmod[1 : (len(zmod) - 1) // 2 + 1]
        zmod_eff_sq = zmod_eff ** 2
        idxs = np.linspace(1, len(zmod_eff), len(zmod_eff))
        freq = np.sum(idxs * zmod_eff_sq) / np.sum(zmod_eff_sq)
        mu_ref = 0.5 / freq                  # reference, absolute time
        if mu_ref >= 2.0 * spacing:
            mu_phi2 = mu_ref
            sd = (1.0 - mu_ref) / 3.0 if mu_ref < 1.0 else mu_ref / 2.0
        else:
            mu_phi2 = 0.25 * t_range / freq  # physical-unit correction
            sd = mu_phi2 / 2.0
        mu_ds.append(X_filled[:, d].mean())
        mu_phi2s.append(mu_phi2)
        sd_phi2s.append(sd)
    return FourierPrior(np.array(mu_ds), np.array(mu_phi2s), np.array(sd_phi2s))


def _truncated_normal_logpdf_unnorm(x, loc, scale):
    """TruncatedNormal(low=1e-6, high=inf) log-density up to additive
    constants that do not depend on x (magi_v2.py:610-627). Softplus keeps
    x > 0, so the hard truncation at 1e-6 is dropped (gradient-identical
    wherever the reference's density is finite)."""
    return -0.5 * ((x - loc) / scale) ** 2


def _gp_marginal_loglik(gram_chol, y_cent, sigma_sq, n):
    """log N(y | mu, K) with K = phi1*R + sigma^2 I given its Cholesky."""
    alpha = jax.scipy.linalg.cho_solve((gram_chol, True), y_cent)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(gram_chol)))
    return -0.5 * (y_cent @ alpha + logdet + n * jnp.log(2.0 * jnp.pi))


def make_hparam_objective(I, X_filled, prior: FourierPrior, nu: float,
                          jitter: float = 1e-6):
    """Negative MAP objective over softplus pre-space (phi1, sigma^2, phi2).

    The TFP GaussianProcess the reference optimizes (magi_v2.py:594-597)
    is exactly: y_d ~ N(mu_d, phi1_d * Matern_{phi2_d} + sigma_d^2 I),
    plus the TruncatedNormal priors. ``jitter`` mirrors TFP's default
    cholesky jitter of 1e-6.
    """
    I = jnp.asarray(np.asarray(I).reshape(-1))
    X = jnp.asarray(np.asarray(X_filled))
    n = I.shape[0]
    dtype = X.dtype
    mu_ds = jnp.asarray(prior.mu_ds, dtype)
    mu_phi2s = jnp.asarray(prior.mu_phi2s, dtype)
    sd_phi2s = jnp.asarray(prior.sd_phi2s, dtype)
    sigma_sq_prior_loc = jnp.asarray((np.asarray(X_filled).std(axis=0) * 0.1) ** 2, dtype)
    eye = jnp.eye(n, dtype=dtype)

    def neg_map(params):
        phi1s = softplus(params["phi1_pre"])
        phi2s = softplus(params["phi2_pre"])
        sigma_sqs = softplus(params["sigma_sq_pre"])

        h = uniform_spacing(I)

        def per_component(phi1, phi2, sigma_sq, y, mu):
            if h is not None:
                gram = matern_gram_uniform(n, h, phi1, phi2, nu)
            else:
                gram = matern_gram(I, phi1, phi2, nu)
            cov = gram + (sigma_sq + jitter) * eye
            chol = jnp.linalg.cholesky(cov)
            return _gp_marginal_loglik(chol, y - mu, sigma_sq, n)

        lls = jax.vmap(per_component)(phi1s, phi2s, sigma_sqs, X.T, mu_ds)

        # priors (magi_v2.py:610-627): flat-ish TN(1e-4, 1000) on phi1,
        # TN((0.1 std)^2, 1000) on sigma^2, Fourier TN on phi2.
        lp = (
            jnp.sum(_truncated_normal_logpdf_unnorm(phi1s, 1e-4, 1000.0))
            + jnp.sum(_truncated_normal_logpdf_unnorm(sigma_sqs, sigma_sq_prior_loc, 1000.0))
            + jnp.sum(_truncated_normal_logpdf_unnorm(phi2s, mu_phi2s, sd_phi2s))
        )
        return -(jnp.sum(lls) + lp)

    init_params = {
        "phi1_pre": softplus_inverse(jnp.asarray(np.asarray(X_filled).std(axis=0) ** 2, dtype)),
        "phi2_pre": softplus_inverse(mu_phi2s),
        "sigma_sq_pre": softplus_inverse(sigma_sq_prior_loc),
    }
    return neg_map, init_params


def fit_kernel_hparams(
    I,
    X_filled,
    nu: float = 2.01,
    learning_rate: float = 0.01,
    num_iters: int = 1000,
    cholesky_jitter: float = 1e-6,
    optimizer: str = "adam",
):
    """Fit (phi1s, phi2s, sigma_sqs) for each column of X_filled.

    Equivalent of reference _fit_kernel_hparams (magi_v2.py:538-691):
    Adam(lr=0.01) for 1000 steps — but all steps run on-device inside one
    lax.scan (single dispatch instead of 1000).

    ``optimizer="lbfgs"`` switches to the jitted on-device L-BFGS
    (ops/lbfgs.py, the BASELINE.json north-star path): same MAP objective,
    measured at the SEIR vignette geometry to converge in 18 iterations
    to a marginally LOWER objective than Adam-1000, 0.04 s execution vs
    1.44 s (trace+compile is ~2 s heavier on first call, amortized by
    the persistent compilation cache). ``num_iters`` then bounds the
    iteration count (early-stopping while_loop) and ``learning_rate``
    is ignored. Default stays "adam" for reference parity
    (magi_v2.py:654: tf_keras Adam lr=0.01 x 1000).

    Returns dict with "phi1s", "phi2s", "sigma_sqs" (host NumPy), matching
    the reference's return signature (magi_v2.py:689-691).
    """
    _I = np.asarray(I).reshape(-1)
    prior = fourier_prior(X_filled, t_range=float(_I[-1] - _I[0]))
    neg_map, params = make_hparam_objective(
        I, X_filled, prior, nu, jitter=cholesky_jitter
    )
    if optimizer == "lbfgs":
        from magi_v2_tpu.ops.lbfgs import lbfgs_minimize

        res = jax.jit(
            lambda p: lbfgs_minimize(
                neg_map, p,
                num_iters=min(num_iters, 200),
                # the objective's natural gradient scale is O(n) nats;
                # 1e-5 sup-norm is far past the MLE's statistical noise
                tol=1e-5,
            )
        )(params)
        params, losses = res.params, res.losses
    elif optimizer == "adam":
        # eps=1e-7 matches tf_keras Adam's default epsilon (reference
        # optimizer, magi_v2.py:654); optax's default is 1e-8.
        opt = optax.adam(learning_rate, eps=1e-7)

        @jax.jit
        def run(params):
            opt_state = opt.init(params)

            def step(carry, _):
                params, opt_state = carry
                loss, grads = jax.value_and_grad(neg_map)(params)
                updates, opt_state = opt.update(grads, opt_state)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), loss

            (params, _), losses = jax.lax.scan(
                step, (params, opt_state), None, length=num_iters
            )
            return params, losses

        params, losses = run(params)
    else:
        raise ValueError(
            f"optimizer must be 'adam' or 'lbfgs', got {optimizer!r}"
        )
    return {
        "phi1s": np.asarray(softplus(params["phi1_pre"])),
        "phi2s": np.asarray(softplus(params["phi2_pre"])),
        "sigma_sqs": np.asarray(softplus(params["sigma_sq_pre"])),
        "losses": np.asarray(losses),
        "prior": prior,
    }
