"""storage='hybrid': banded-GN whitening around the EXACT dense-operator
posterior (sampler/modes.py, sampler/precond.py
make_tempered_logp_grad_gn_hybrid).

The invariants certified here:

1. The hybrid target is the EXACT posterior expressed in the banded-GN
   whitened coordinates — log-density differences through the hybrid
   logp_grad match the centered dense log-posterior on the SAME exact
   PosteriorData (the whitening is a fixed linear map, so differences are
   Jacobian-free).
2. The hybrid target genuinely differs from the banded (truncated) target
   when band truncation drops real operator mass — the whole point of the
   mode (round-4 adjudication: truncation is a TARGET error at
   Lorenz N_I=1025/b=100, DEVIATIONS.md #26).
3. Validation: hybrid requires a bandsize and reparam='precond'.
4. End-to-end predict(storage='hybrid') runs and returns finite draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from magi_v2_tpu import MAGI_v2, MagiConfig
from magi_v2_tpu.models import lorenz_f_vec
from magi_v2_tpu.posterior import make_log_posterior
from magi_v2_tpu.sampler.magi_state import flatten_state
from magi_v2_tpu.sampler.precond import whiten_X_banded
from magi_v2_tpu.utils.data import simulate_ode


@pytest.fixture(scope="module")
def lorenz_model():
    """Small Lorenz fit with a DELIBERATELY tight band (truncation drops
    real operator mass, so banded and hybrid targets must differ)."""
    ts_obs, X_obs, _ = simulate_ode(
        lorenz_f_vec,
        x0=np.array([-8.0, 7.0, 27.0]),
        thetas=np.array([10.0, 28.0, 8.0 / 3.0]),
        t_max=2.0,
        n_obs=17,
        noise_sd=0.5,
        substeps=20,
    )
    model = MAGI_v2(
        D_thetas=3, ts_obs=ts_obs, X_obs=X_obs, bandsize=4,
        f_vec=lorenz_f_vec,
        config=MagiConfig().replace(dtype=jnp.float64),
    )
    model.initial_fit(discretization=2)
    return model


def _mode_and_data(model, storage):
    mode, data, *_ = model._build_sampling_setup("precond", storage,
                                                 jnp.float64)
    return mode, data


def test_hybrid_matches_exact_centered_posterior(lorenz_model):
    """logp differences through the hybrid coordinates == differences of
    the centered log-posterior on the exact dense data."""
    model = lorenz_model
    mode, data = _mode_and_data(model, "hybrid")
    assert data.C_inv_sqrts is not None  # exact dense data
    lp_centered = make_log_posterior(data, model.f_vec)
    U_blocks, _U_dinv = mode.factor

    rng = np.random.default_rng(0)
    vals_h, vals_c = [], []
    for _ in range(3):
        X = jnp.asarray(
            np.asarray(model.Xhat_init)
            + 0.05 * rng.standard_normal(model.Xhat_init.shape)
        )
        Z = whiten_X_banded(X, jnp.asarray(model.mu_ds), U_blocks)
        s = jnp.asarray(rng.standard_normal(model.D))
        t = jnp.asarray(rng.standard_normal(model.D_thetas))
        q = flatten_state(Z, s, t)
        v_h, g_h = mode.logp_grad(q, jnp.asarray(0.8))
        v_c = lp_centered(X, s, t, 0.8)
        assert np.isfinite(float(v_h)) and np.all(np.isfinite(g_h))
        vals_h.append(float(v_h))
        vals_c.append(float(v_c))
    # relative-energy form: equal up to one additive constant
    d_h = np.diff(vals_h)
    d_c = np.diff(vals_c)
    np.testing.assert_allclose(d_h, d_c, rtol=1e-6, atol=1e-8)


def test_hybrid_differs_from_banded_target(lorenz_model):
    """With material truncation (recorded band_truncation) the banded and
    hybrid targets are DIFFERENT distributions: their log-density
    differences disagree."""
    model = lorenz_model
    assert max(model.band_truncation.values()) > 0.01
    mode_h, _ = _mode_and_data(model, "hybrid")
    mode_b, _ = _mode_and_data(model, "banded")

    rng = np.random.default_rng(1)
    d_h, d_b = [], []
    U_h = mode_h.factor[0]
    U_b = mode_b.factor[0]
    prev_h = prev_b = None
    for _ in range(3):
        X = jnp.asarray(
            np.asarray(model.Xhat_init)
            + 0.05 * rng.standard_normal(model.Xhat_init.shape)
        )
        s = jnp.asarray(rng.standard_normal(model.D))
        t = jnp.asarray(rng.standard_normal(model.D_thetas))
        q_h = flatten_state(
            whiten_X_banded(X, jnp.asarray(model.mu_ds), U_h), s, t
        )
        q_b = flatten_state(
            whiten_X_banded(X, jnp.asarray(model.mu_ds), U_b), s, t
        )
        v_h, _ = mode_h.logp_grad(q_h, jnp.asarray(1.0))
        v_b, _ = mode_b.logp_grad(q_b, jnp.asarray(1.0))
        if prev_h is not None:
            d_h.append(float(v_h) - prev_h)
            d_b.append(float(v_b) - prev_b)
        prev_h, prev_b = float(v_h), float(v_b)
    # same X-points, same coordinate-free comparison: the truncated target
    # must disagree with the exact one by far more than roundoff
    assert np.max(np.abs(np.array(d_h) - np.array(d_b))) > 1e-3


def test_hybrid_validation_errors(lorenz_model):
    model = lorenz_model
    with pytest.raises(ValueError, match="precond"):
        model._build_sampling_setup("centered", "hybrid", jnp.float64)

    # hybrid without a bandsize: no GN band to whiten with
    ts_obs = np.asarray(model.ts_obs)
    X_obs = np.asarray(model.X_obs)
    m2 = MAGI_v2(D_thetas=3, ts_obs=ts_obs, X_obs=X_obs, bandsize=None,
                 f_vec=lorenz_f_vec,
                 config=MagiConfig().replace(dtype=jnp.float64))
    m2.initial_fit(discretization=1)
    with pytest.raises(ValueError, match="bandsize"):
        m2._build_sampling_setup("precond", "hybrid", jnp.float64)


def test_hybrid_predict_end_to_end(lorenz_model):
    model = lorenz_model
    res = model.predict(
        num_results=20, num_burnin_steps=20, num_chains=4, seed=0,
        init_jitter=0.01, algorithm="hmc", hmc_num_leapfrogs=8,
        storage="hybrid", reparam="precond",
    )
    th = np.asarray(res["thetas_samps"])
    assert np.all(np.isfinite(th))
    X = np.asarray(res["X_samps"])
    assert np.all(np.isfinite(X))


def test_gn_anchor_invariance(lorenz_model):
    """gn_anchor is a pure coordinate/zero-point change: log-density
    differences at the SAME natural points agree between the default
    (init) anchor and a perturbed anchor (sampler/modes.py
    build_sampling_mode anchor=)."""
    model = lorenz_model
    rng = np.random.default_rng(7)
    aX = np.asarray(model.Xhat_init, np.float64) + 0.1 * rng.standard_normal(
        model.Xhat_init.shape
    )
    ath = np.asarray(model.thetas_init, np.float64) * 1.2
    mode_0, _ = _mode_and_data(model, "hybrid")
    mode_a, *_ = model._build_sampling_setup(
        "precond", "hybrid", jnp.float64,
        gn_anchor={"X": aX, "thetas": ath},
    )
    U_0, U_a = mode_0.factor[0], mode_a.factor[0]

    vals_0, vals_a = [], []
    for _ in range(3):
        X = jnp.asarray(
            np.asarray(model.Xhat_init)
            + 0.05 * rng.standard_normal(model.Xhat_init.shape)
        )
        s = jnp.asarray(rng.standard_normal(model.D))
        t = jnp.asarray(rng.standard_normal(model.D_thetas))
        q_0 = flatten_state(
            whiten_X_banded(X, jnp.asarray(model.mu_ds), U_0), s, t
        )
        q_a = flatten_state(
            whiten_X_banded(X, jnp.asarray(model.mu_ds), U_a), s, t
        )
        v_0, g_0 = mode_0.logp_grad(q_0, jnp.asarray(0.8))
        v_a, g_a = mode_a.logp_grad(q_a, jnp.asarray(0.8))
        assert np.isfinite(float(v_0)) and np.isfinite(float(v_a))
        assert np.all(np.isfinite(g_a))
        vals_0.append(float(v_0))
        vals_a.append(float(v_a))
    np.testing.assert_allclose(
        np.diff(vals_0), np.diff(vals_a), rtol=1e-6, atol=1e-8
    )
    # the anchored mode's X0 is the whitened ANCHOR, not the init
    z_anchor = whiten_X_banded(
        jnp.asarray(aX), jnp.asarray(model.mu_ds), U_a
    )
    np.testing.assert_allclose(
        np.asarray(mode_a.X0), np.asarray(z_anchor), rtol=1e-9, atol=1e-9
    )


def test_gn_anchor_predict_end_to_end(lorenz_model):
    model = lorenz_model
    rng = np.random.default_rng(11)
    aX = np.asarray(model.Xhat_init, np.float64) + 0.05 * rng.standard_normal(
        model.Xhat_init.shape
    )
    res = model.predict(
        num_results=10, num_burnin_steps=10, num_chains=2, seed=0,
        init_jitter=0.01, algorithm="hmc", hmc_num_leapfrogs=8,
        storage="hybrid", reparam="precond",
        gn_anchor={"X": aX, "thetas": np.asarray(model.thetas_init)},
    )
    assert np.all(np.isfinite(np.asarray(res["thetas_samps"])))
    assert np.all(np.isfinite(np.asarray(res["X_samps"])))


def test_gn_anchor_validation(lorenz_model):
    model = lorenz_model
    with pytest.raises(ValueError, match="unknown keys"):
        model._build_sampling_setup(
            "precond", "hybrid", jnp.float64, gn_anchor={"bogus": 1}
        )
    with pytest.raises(ValueError, match="shape"):
        model._build_sampling_setup(
            "precond", "hybrid", jnp.float64,
            gn_anchor={"X": np.zeros((3, 3))},
        )
    with pytest.raises(ValueError, match="banded-GN"):
        model._build_sampling_setup(
            "precond", "dense", jnp.float64,
            gn_anchor={"thetas": np.asarray(model.thetas_init)},
        )


def test_exact_operators_cache(lorenz_model):
    model = lorenz_model
    ops1 = model._exact_operators()
    ops2 = model._exact_operators()
    assert ops1[0] is ops2[0]  # cached, not rebuilt
    # exact C^-1 differs from the in-place truncated one
    assert not np.allclose(ops1[0], model.C_d_invs)
