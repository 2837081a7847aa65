"""predict(init_states=...) — user-supplied NATURAL-coordinate chain
starts (sampler/modes.py apply_init_states).

The override must reproduce the default heuristic init exactly when fed
the model's own (Xhat_init, thetas_init, sigma_sqs_init) — i.e. the
natural->sampling-coordinate maps (f64 whitening per mode, the
inverse-softplus floor for sigma/theta) are the SAME ones predict() uses
— and must validate shapes/keys/pinning conflicts loudly. No reference
counterpart (the reference is single-chain from one heuristic init,
magi_v2.py:374-383); the feature exists for overdispersed / Laplace-
scattered starts (Hes1 unobserved-H mixing, DEVIATIONS.md #23).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from magi_v2_tpu.sampler.modes import apply_init_states


@pytest.fixture(scope="module")
def small_seir_model():
    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu.models import seir_f_vec
    from magi_v2_tpu.utils.data import simulate_ode

    ts, X, _ = simulate_ode(
        seir_f_vec,
        x0=np.array([0.1, 0.05, 0.0]),
        thetas=np.array([6.0, 0.6, 1.8]),
        t_max=2.0,
        n_obs=21,
        noise_sd=0.005,
    )
    cfg = MagiConfig().replace(hparam_num_iters=200, init_num_iters=500)
    model = MAGI_v2(3, ts, X, bandsize=20, f_vec=seir_f_vec, config=cfg)
    model.initial_fit(discretization=1)
    return model


MODES = [
    ("centered", "dense"),
    ("whitened", "dense"),
    ("precond", "dense"),
    ("precond", "banded"),
    ("precond", "hybrid"),
]


@pytest.mark.parametrize("reparam,storage", MODES)
def test_roundtrip_matches_default_init(small_seir_model, reparam, storage):
    """Feeding the model's own heuristic init through init_states must
    land on the same sampling coordinates as the default q0 (the f64
    whitening that built mode.X0)."""
    m = small_seir_model
    dtype = jnp.float32
    mode, data, sigma_LB, _, _ = m._build_sampling_setup(
        reparam, storage, dtype
    )
    N, D, Dth = m.mag_I, m.D, m.D_thetas
    C = 2
    q0 = np.zeros((C, N * D + D + Dth), np.float32)
    q0 = apply_init_states(
        q0,
        {
            "X": np.asarray(m.Xhat_init),
            "thetas": np.asarray(m.thetas_init),
            "sigma_sqs": np.asarray(m.sigma_sqs_init),
        },
        mode, m, sigma_LB, None,
    )
    X_expect = np.asarray(mode.X0, np.float64).reshape(-1)
    for c in range(C):
        np.testing.assert_allclose(
            q0[c, : N * D], X_expect, rtol=1e-5, atol=1e-5
        )
    # theta/sigma blocks invert back to the natural values through the
    # same softplus predict() samples through
    from magi_v2_tpu.posterior import softplus

    th_back = np.asarray(softplus(jnp.asarray(q0[0, N * D + D:])))
    np.testing.assert_allclose(th_back, m.thetas_init, rtol=1e-5, atol=1e-6)
    sig_back = np.asarray(
        softplus(jnp.asarray(q0[0, N * D : N * D + D]))
    ) + np.asarray(sigma_LB)
    keep = m.sigma_sqs_init > np.asarray(sigma_LB)
    np.testing.assert_allclose(
        sig_back[keep], m.sigma_sqs_init[keep], rtol=1e-4
    )


def test_predict_identical_to_default_when_fed_defaults(small_seir_model):
    """End-to-end: a centered run with init_states == the heuristic init
    must produce bit-identical draws to the default run."""
    m = small_seir_model
    kw = dict(
        num_results=3, num_burnin_steps=3, num_chains=2, seed=0,
        init_jitter=0.0, reparam="centered", algorithm="hmc",
        hmc_num_leapfrogs=2, use_annealing=False,
    )
    r_default = m.predict(**kw)
    r_override = m.predict(
        init_states={
            "X": np.asarray(m.Xhat_init),
            "thetas": np.asarray(m.thetas_init),
            "sigma_sqs": np.asarray(m.sigma_sqs_init),
        },
        **kw,
    )
    np.testing.assert_array_equal(
        r_default["thetas_samps"], r_override["thetas_samps"]
    )
    np.testing.assert_array_equal(
        np.asarray(r_default["X_samps"]), np.asarray(r_override["X_samps"])
    )


def test_predict_per_chain_scatter_runs(small_seir_model):
    """Per-chain scattered X + theta starts through the GN-whitened mode:
    the override must map each chain independently and sample finitely."""
    m = small_seir_model
    rng = np.random.default_rng(0)
    C = 2
    X0 = np.asarray(m.Xhat_init)
    Xs = X0[None] + 0.05 * rng.standard_normal((C,) + X0.shape)
    ths = np.abs(
        np.asarray(m.thetas_init)[None]
        * (1.0 + 0.2 * rng.standard_normal((C, m.D_thetas)))
    )
    res = m.predict(
        num_results=3, num_burnin_steps=3, num_chains=C, seed=0,
        reparam="precond", algorithm="hmc", hmc_num_leapfrogs=2,
        use_annealing=False,
        init_states={"X": Xs, "thetas": ths},
    )
    assert np.all(np.isfinite(res["thetas_samps"]))
    assert np.all(np.isfinite(np.asarray(res["X_samps"])))


def test_validation_errors(small_seir_model):
    m = small_seir_model
    dtype = jnp.float32
    mode, data, sigma_LB, _, pre_fix = m._build_sampling_setup(
        "centered", "dense", dtype
    )
    N, D, Dth = m.mag_I, m.D, m.D_thetas
    q0 = np.zeros((2, N * D + D + Dth), np.float32)

    with pytest.raises(ValueError, match="unknown keys"):
        apply_init_states(q0, {"bogus": 1}, mode, m, sigma_LB, None)
    with pytest.raises(ValueError, match="shape"):
        apply_init_states(
            q0, {"thetas": np.ones((3, Dth))}, mode, m, sigma_LB, None
        )
    with pytest.raises(ValueError, match="NaN"):
        bad = np.asarray(m.Xhat_init).copy()
        bad[0, 0] = np.nan
        apply_init_states(q0, {"X": bad}, mode, m, sigma_LB, None)
    with pytest.raises(ValueError, match="sigma_sqs_fixed"):
        apply_init_states(
            q0, {"sigma_sqs": np.full(D, 0.01)}, mode, m, sigma_LB, 0.01
        )
