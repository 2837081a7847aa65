"""Fused log-posterior vs an independent NumPy transliteration of the
reference formula (magi_v2.py:308-348) on random fixtures."""

import jax
import jax.numpy as jnp
import numpy as np

from magi_v2_tpu import preprocess
from magi_v2_tpu.models import seir_f_vec
from magi_v2_tpu.posterior import (
    make_posterior_data,
    make_log_posterior,
    make_value_and_grad,
    softplus_inverse,
)


def numpy_log_posterior(
    X, sigma_pre, theta_pre, beta_temp, C_invs, m_ds, K_invs, mu_ds, beta,
    N_ds, not_nan_idxs, not_nan_cols, y_obs, sigma_LB, f_vec_np,
    C_inv_sqrts=None, K_inv_sqrts=None,
):
    """Direct NumPy transliteration of magi_v2.py:308-348.

    With C_inv_sqrts / K_inv_sqrts (R, S with R'R = C^{-1}, S'S = K^{-1})
    the quadratics are sums of squares, ||R x||^2 and ||S r||^2, and
    C_invs / K_invs are not read: at dense grids the x'Ax form cancels
    terms far larger than the result, even in float64."""
    softplus = lambda x: np.log1p(np.exp(x))
    sigma_sqs = softplus(sigma_pre) + sigma_LB
    thetas = softplus(theta_pre)
    log_jac_sigma = np.sum(sigma_pre - softplus(sigma_pre))
    log_jac_theta = np.sum(theta_pre - softplus(theta_pre))

    def quad(A, A_sqrt, d, v):
        if A_sqrt is None:
            return v @ A[d] @ v
        w = A_sqrt[d] @ v
        return w @ w

    D = X.shape[1]
    X_cent = (X - mu_ds[None, :]).T  # (D, N)
    t1 = sum(quad(C_invs, C_inv_sqrts, d, X_cent[d]) for d in range(D))
    f_vals = f_vec_np(X, thetas).T
    t2 = 0.0
    for d in range(D):
        r = f_vals[d] - m_ds[d] @ X_cent[d]
        t2 += quad(K_invs, K_inv_sqrts, d, r)
    t3 = np.sum(N_ds * np.log(2 * np.pi * sigma_sqs))
    Xf = X.ravel()
    t4 = np.sum(
        (Xf[not_nan_idxs] - y_obs) ** 2 / sigma_sqs[not_nan_cols]
    )
    return beta_temp * (
        -0.5 * ((t1 + t2) / beta + t3 + t4) + log_jac_sigma + log_jac_theta
    )


def _fixture(seed=0, N=21, D=3):
    rng = np.random.default_rng(seed)
    I = np.linspace(0, 2, N).reshape(-1, 1)
    X_obs = rng.normal(size=(N, D)) * 0.1 + 0.3
    X_obs[rng.random(X_obs.shape) < 0.3] = np.nan
    obs_index = preprocess.build_observation_index(X_obs)
    # random SPD matrices standing in for the kernel inverses
    def spd():
        a = rng.normal(size=(N, N))
        return a @ a.T / N + np.eye(N)
    C_invs = np.stack([spd() for _ in range(D)])
    K_invs = np.stack([spd() for _ in range(D)])
    m_ds = np.stack([rng.normal(size=(N, N)) * 0.1 for _ in range(D)])
    mu_ds = rng.normal(size=(D,))
    beta = D * N / obs_index.N_ds.sum()
    sigma_LB = np.full(D, 1e-4)
    return I, X_obs, obs_index, C_invs, m_ds, K_invs, mu_ds, beta, sigma_LB


def test_log_posterior_matches_numpy_transliteration():
    I, X_obs, obs_index, C_invs, m_ds, K_invs, mu_ds, beta, sigma_LB = _fixture()
    N, D = X_obs.shape
    data = make_posterior_data(
        I, C_invs, m_ds, K_invs, mu_ds, beta, obs_index, sigma_LB, jnp.float64
    )
    lp = jax.jit(make_log_posterior(data, seir_f_vec))

    rng = np.random.default_rng(1)
    for _ in range(5):
        X = rng.normal(size=(N, D)) * 0.2 + 0.3
        sig = rng.normal(size=(D,))
        th = rng.normal(size=(3,))
        bt = rng.uniform(0.1, 1.5)
        ours = float(lp(jnp.asarray(X), jnp.asarray(sig), jnp.asarray(th), bt))
        ref = numpy_log_posterior(
            X, sig, th, bt, C_invs, m_ds, K_invs, mu_ds, beta,
            obs_index.N_ds, obs_index.not_nan_idxs, obs_index.not_nan_cols,
            obs_index.y_observed, sigma_LB,
            lambda Xv, tv: np.asarray(seir_f_vec(jnp.asarray(I), jnp.asarray(Xv), jnp.asarray(tv))),
        )
        np.testing.assert_allclose(ours, ref, rtol=1e-10)


def test_value_and_grad_finite_and_consistent():
    I, X_obs, obs_index, C_invs, m_ds, K_invs, mu_ds, beta, sigma_LB = _fixture(7)
    N, D = X_obs.shape
    data = make_posterior_data(
        I, C_invs, m_ds, K_invs, mu_ds, beta, obs_index, sigma_LB, jnp.float64
    )
    vag = jax.jit(make_value_and_grad(data, seir_f_vec))
    X = jnp.asarray(np.random.default_rng(2).normal(size=(N, D)) * 0.1 + 0.3)
    sig = jnp.zeros(D)
    th = jnp.zeros(3)
    val, (gX, gs, gt) = vag(X, sig, th, jnp.asarray(1.0))
    assert np.isfinite(float(val))
    for g in (gX, gs, gt):
        assert np.all(np.isfinite(np.asarray(g)))
    # finite-difference spot check on theta
    lp = make_log_posterior(data, seir_f_vec)
    h = 1e-6
    e0 = jnp.zeros(3).at[0].set(h)
    fd = (float(lp(X, sig, th + e0, 1.0)) - float(lp(X, sig, th - e0, 1.0))) / (2 * h)
    np.testing.assert_allclose(float(gt[0]), fd, rtol=1e-5)


def test_beta_temp_scales_and_stops_gradient():
    I, X_obs, obs_index, C_invs, m_ds, K_invs, mu_ds, beta, sigma_LB = _fixture(9)
    N, D = X_obs.shape
    data = make_posterior_data(
        I, C_invs, m_ds, K_invs, mu_ds, beta, obs_index, sigma_LB, jnp.float64
    )
    lp = make_log_posterior(data, seir_f_vec)
    X = jnp.asarray(np.random.default_rng(3).normal(size=(N, D)))
    v1 = float(lp(X, jnp.zeros(D), jnp.zeros(3), 1.0))
    v2 = float(lp(X, jnp.zeros(D), jnp.zeros(3), 0.5))
    np.testing.assert_allclose(v2, 0.5 * v1, rtol=1e-12)
    g = jax.grad(lambda bt: lp(X, jnp.zeros(D), jnp.zeros(3), bt))(jnp.asarray(1.0))
    assert float(g) == 0.0  # stop_gradient on the temperature


def test_softplus_inverse_roundtrip():
    y = jnp.asarray(np.geomspace(1e-8, 50.0, 40))
    x = softplus_inverse(y)
    np.testing.assert_allclose(np.asarray(jax.nn.softplus(x)), np.asarray(y),
                               rtol=1e-9)


def test_posterior_invariant_to_obs_index_permutation():
    """SURVEY.md §4 property: permuting the order of the observed-entry
    index lists must not change the posterior (t4 is a sum)."""
    I, X_obs, obs_index, C_invs, m_ds, K_invs, mu_ds, beta, sigma_LB = _fixture(11)
    N, D = X_obs.shape
    rng = np.random.default_rng(12)
    perm = rng.permutation(len(obs_index.not_nan_idxs))
    from magi_v2_tpu.preprocess import ObservationIndex

    obs_perm = ObservationIndex(
        not_nan_idxs=obs_index.not_nan_idxs[perm],
        not_nan_cols=obs_index.not_nan_cols[perm],
        y_observed=obs_index.y_observed[perm],
        N_ds=obs_index.N_ds,
    )
    d1 = make_posterior_data(I, C_invs, m_ds, K_invs, mu_ds, beta,
                             obs_index, sigma_LB, jnp.float64)
    d2 = make_posterior_data(I, C_invs, m_ds, K_invs, mu_ds, beta,
                             obs_perm, sigma_LB, jnp.float64)
    lp1 = make_log_posterior(d1, seir_f_vec)
    lp2 = make_log_posterior(d2, seir_f_vec)
    X = jnp.asarray(rng.normal(size=(N, D)))
    s, t = jnp.asarray(rng.normal(size=D)), jnp.asarray(rng.normal(size=3))
    np.testing.assert_allclose(
        float(lp1(X, s, t, 1.0)), float(lp2(X, s, t, 1.0)), rtol=1e-12
    )


def test_sqrt_factored_matches_plain():
    """||R x||^2 factored evaluation == x'Ax evaluation (f64)."""
    from magi_v2_tpu.ops.linalg import sym_sqrt

    I, X_obs, obs_index, C_invs, m_ds, K_invs, mu_ds, beta, sigma_LB = _fixture(21)
    N, D = X_obs.shape
    plain = make_posterior_data(I, C_invs, m_ds, K_invs, mu_ds, beta,
                                obs_index, sigma_LB, jnp.float64)
    factored = make_posterior_data(
        I, C_invs, m_ds, K_invs, mu_ds, beta, obs_index, sigma_LB,
        jnp.float64,
        C_inv_sqrts=np.asarray(sym_sqrt(jnp.asarray(C_invs))),
        K_inv_sqrts=np.asarray(sym_sqrt(jnp.asarray(K_invs))),
    )
    lp1 = make_log_posterior(plain, seir_f_vec)
    lp2 = make_log_posterior(factored, seir_f_vec)
    rng = np.random.default_rng(22)
    for _ in range(3):
        X = jnp.asarray(rng.normal(size=(N, D)))
        s, t = jnp.asarray(rng.normal(size=D)), jnp.asarray(rng.normal(size=3))
        np.testing.assert_allclose(
            float(lp2(X, s, t, 0.9)), float(lp1(X, s, t, 0.9)), rtol=1e-9
        )


def test_factored_numpy_transliteration_matches_factored_posterior():
    """The NumPy transliteration through R, S (||R x||^2, ||S r||^2) agrees
    with the fused posterior given the same factors."""
    from magi_v2_tpu.ops.linalg import sym_sqrt

    I, X_obs, obs_index, C_invs, m_ds, K_invs, mu_ds, beta, sigma_LB = _fixture(31)
    N, D = X_obs.shape
    R = np.asarray(sym_sqrt(jnp.asarray(C_invs)))
    S = np.asarray(sym_sqrt(jnp.asarray(K_invs)))
    data = make_posterior_data(I, C_invs, m_ds, K_invs, mu_ds, beta,
                               obs_index, sigma_LB, jnp.float64,
                               C_inv_sqrts=R, K_inv_sqrts=S)
    lp = jax.jit(make_log_posterior(data, seir_f_vec))
    rng = np.random.default_rng(32)
    for _ in range(3):
        X = rng.normal(size=(N, D)) * 0.2 + 0.3
        sig, th = rng.normal(size=(D,)), rng.normal(size=(3,))
        ref = numpy_log_posterior(
            X, sig, th, 0.8, None, m_ds, None, mu_ds, beta,
            obs_index.N_ds, obs_index.not_nan_idxs, obs_index.not_nan_cols,
            obs_index.y_observed, sigma_LB,
            lambda Xv, tv: np.asarray(seir_f_vec(jnp.asarray(I), jnp.asarray(Xv), jnp.asarray(tv))),
            C_inv_sqrts=R, K_inv_sqrts=S,
        )
        ours = float(lp(jnp.asarray(X), jnp.asarray(sig), jnp.asarray(th), 0.8))
        np.testing.assert_allclose(ours, ref, rtol=1e-10)
