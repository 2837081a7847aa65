"""Hes1 (unobserved component) regression tests.

The round-1 failure (VERDICT.md Missing #3) had three measured layers:
the reference's index-unit Fourier prior pinned the H/P/M lengthscales
40x below the observation spacing (whitened GP -> open theta ridges);
the magi_v2 beta tempering down-weighted the manifold constraint; and
the posterior is genuinely multimodal (a decoupled-H mode out-densities
the truth basin, so only basin-trapped — centered, unannealed — sampling
reproduces the published recoveries). See DEVIATIONS.md #5,
examples/hes1.py, and results/hes1_long2.json.
"""

import numpy as np
import pytest

from magi_v2_tpu import MAGI_v2, MagiConfig
from magi_v2_tpu.models import MODEL_REGISTRY, hes1_log_f_vec
from magi_v2_tpu.utils.data import simulate_ode

TRUE = np.array(MODEL_REGISTRY["hes1"].true_thetas)


@pytest.fixture(scope="module")
def hes1_model():
    ts_obs, _, X_true = simulate_ode(
        MODEL_REGISTRY["hes1"].f_vec, x0=np.array([1.439, 2.037, 17.904]),
        thetas=TRUE, t_max=240.0, n_obs=33, noise_sd=0.0, substeps=200,
    )
    rng = np.random.default_rng(0)
    X_obs_log = np.log(X_true) + 0.15 * rng.standard_normal(X_true.shape)
    X_obs_log[:, 2] = np.nan
    cfg = MagiConfig().replace(hparam_num_iters=400, init_num_iters=3000)
    model = MAGI_v2(7, ts_obs, X_obs_log, bandsize=None,
                    f_vec=hes1_log_f_vec, config=cfg)
    model.initial_fit(discretization=2)
    return model, X_true


def test_lengthscales_resolve_the_grid(hes1_model):
    """The resolution-gated prior must fit lengthscales the 7.5-min
    observation grid can represent (the reference's index-unit prior
    pinned them at ~0.2 min; likelihood-preferred band is 25-40)."""
    model, _ = hes1_model
    assert np.all(model.phi2s > 10.0), model.phi2s
    assert np.all(model.phi2s < 80.0), model.phi2s


def test_posterior_prefers_truth_over_degenerate(hes1_model):
    """With sane lengthscales the target orders truth >> degenerate —
    the property whose violation produced the round-1 theta drift
    (measured: -808 vs -78131 at default beta; the broken-prior target
    preferred the drifted states)."""
    import jax.numpy as jnp

    from magi_v2_tpu.ops.linalg import sym_sqrt
    from magi_v2_tpu.posterior import (log_posterior, make_posterior_data,
                                       softplus_inverse)

    model, X_true = hes1_model
    grid = model.I.flatten()
    tt = np.linspace(0, 240, len(X_true))
    X_truth = np.stack(
        [np.interp(grid, tt, np.log(X_true[:, d])) for d in range(3)], axis=1
    )
    with model._setup_device_ctx():
        R64 = np.asarray(sym_sqrt(jnp.asarray(model.C_d_invs)))
        S64 = np.asarray(sym_sqrt(jnp.asarray(model.K_d_invs)))
        data = make_posterior_data(
            model.I, model.C_d_invs, model.m_ds, model.K_d_invs,
            model.mu_ds, model.beta, model.obs_index,
            np.full(3, 1e-4), jnp.float64,
            C_inv_sqrts=R64, K_inv_sqrts=S64,
        )
        sig_pre = softplus_inverse(jnp.asarray([0.0225 - 1e-4] * 3))

        def lp(X, th):
            th_pre = softplus_inverse(jnp.asarray(np.maximum(th, 1e-8)))
            return float(log_posterior(
                data, hes1_log_f_vec, jnp.asarray(X), sig_pre, th_pre, 1.0
            ))

        v_truth = lp(X_truth, TRUE)
        X_deg = model.Xhat_init.copy()
        X_deg[:, 2] = X_deg[:, 2].mean()
        v_deg = lp(
            X_deg,
            np.array([1e-3, 1e-3, 1e-3, 3e-3, 1e-3, 0.438, 1e-3]),
        )
    assert v_truth > v_deg + 1000.0, (v_truth, v_deg)


@pytest.mark.slow
def test_hes1_theta_recovery(hes1_model):
    """Full recovery in the basin-trapped (reference-regime) mode — the
    examples/hes1.py recipe at a CI-sized config. The CONVERGED authority
    for this posterior is the 16x3000+8000 run (results/hes1_long2.json:
    rhat_max 1.028, ESS_min 639, 16/16
    chains in the truth basin): theta ratios to truth
    (0.69, 1.26, 1.11, 1.05, 1.17, 1.36, 0.57) — i.e. the g~0.57x and
    f~1.36x offsets are properties of the posterior itself (g posterior
    sd 0.03, f sd 13.2: weakly identified), not sampler error. The
    factor-2.5 band below accommodates THIS config's 4x600+600 noise on
    top of those converged offsets."""
    model, X_true = hes1_model
    model.beta = 1.0
    res = model.predict(
        num_results=600, num_burnin_steps=600, num_chains=4, seed=0,
        init_jitter=0.02, reparam="centered", use_annealing=False,
        sigma_sqs_fixed=0.15 ** 2,
    )
    th = res["thetas_samps"].mean(axis=(0, 1))
    # every parameter within a factor of 2.5 of truth (right basin; the
    # published MAGI Hes1 error bars are comparable on several params —
    # measured across runs: g sits at 0.42-0.58x truth, f at 0.72-1.35x)
    assert np.all(th > TRUE / 2.5), th
    assert np.all(th < TRUE * 2.5), th
    # and the tightly-identified middle parameters within 25%
    np.testing.assert_allclose(th[2], TRUE[2], rtol=0.25)
    np.testing.assert_allclose(th[3], TRUE[3], rtol=0.25)
    NI = model.mag_I
    logH_true = np.interp(
        np.linspace(0, 240, NI), np.linspace(0, 240, len(X_true)),
        np.log(X_true[:, 2]),
    )
    H = res["X_samps"][..., 2].reshape(-1, NI)
    lo, hi = np.quantile(H, [0.025, 0.975], axis=0)
    assert ((logH_true >= lo) & (logH_true <= hi)).mean() > 0.6
