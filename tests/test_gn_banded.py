"""Banded Gauss-Newton whitening: the O(ND*b) large-grid sampler path.

Covers VERDICT.md round-1 items 2/5 (banded whitening factor) and the
advisor's float32-safety finding on the banded storage path: host banded
linear algebra oracles, banded-vs-dense GN precision equality, exactness of
the truncated triangular inverse reparameterization, and the end-to-end
predict(storage='banded', reparam='precond') flow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from magi_v2_tpu.ops.banded_host import (
    banded_cholesky_upper,
    dense_to_banded_np,
)


def band_to_dense(band):
    two_b1, n = band.shape
    b = (two_b1 - 1) // 2
    out = np.zeros((n, n))
    for k in range(-b, b + 1):
        for i in range(max(0, -k), min(n, n - k)):
            out[i, i + k] = band[b + k, i]
    return out


def random_spd_banded(rng, n, b):
    a = rng.standard_normal((n, n))
    a = a @ a.T + n * np.eye(n)
    mask = np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= b
    return np.where(mask, a, 0.0)


def test_banded_cholesky_matches_dense():
    rng = np.random.default_rng(0)
    A = random_spd_banded(rng, 40, 6)
    U_band, jitter = banded_cholesky_upper(dense_to_banded_np(A, 6))
    U = band_to_dense(U_band)
    assert jitter == 0.0
    np.testing.assert_allclose(U.T @ U, A, atol=1e-8)
    # upper-triangular with positive diagonal
    assert np.allclose(U, np.triu(U))
    assert np.all(np.diag(U) > 0)


def test_banded_cholesky_jitter_repairs_indefinite():
    rng = np.random.default_rng(1)
    A = random_spd_banded(rng, 30, 5)
    # shift the spectrum slightly negative — the failure mode band
    # truncation of a PSD operator actually produces
    w = np.linalg.eigvalsh(A)
    A = A - (w.min() + 1e-6 * w.max()) * np.eye(30)
    assert np.linalg.eigvalsh(A).min() < 0
    U_band, jitter = banded_cholesky_upper(dense_to_banded_np(A, 5))
    assert jitter > 0.0
    U = band_to_dense(U_band)
    assert np.all(np.isfinite(U))
    # repaired factor stays close to the original operator
    np.testing.assert_allclose(U.T @ U, A, atol=1e-4 * w.max())


def test_block_banded_triangular_solve_matches_dense():
    """The exact back substitution against a banded Cholesky factor — the
    per-leapfrog unwhitening of the banded GN mode."""
    from magi_v2_tpu.ops.banded import (
        banded_to_blocks_upper,
        block_banded_triangular_solve_upper,
        dense_to_banded,
    )

    rng = np.random.default_rng(2)
    for N, b in [(40, 6), (300, 37), (333, 150)]:
        A = random_spd_banded(rng, N, b)
        U_band, _ = banded_cholesky_upper(dense_to_banded_np(A, b))
        U = band_to_dense(U_band)
        blocks = banded_to_blocks_upper(jnp.asarray(dense_to_banded(U, b)))
        y = rng.standard_normal((4, N))
        x = np.asarray(
            block_banded_triangular_solve_upper(blocks, jnp.asarray(y))
        )
        ref = np.linalg.solve(U, y.T).T
        np.testing.assert_allclose(x, ref, atol=1e-8 * np.abs(ref).max())
        # precomputed f64 diagonal-tile inverses (the precision-safe path)
        from magi_v2_tpu.ops.banded import banded_diag_tile_inverses

        dinv = banded_diag_tile_inverses(blocks, N)
        x2 = np.asarray(
            block_banded_triangular_solve_upper(
                blocks, jnp.asarray(y), diag_inv=dinv
            )
        )
        np.testing.assert_allclose(x2, ref, atol=1e-8 * np.abs(ref).max())


def test_block_banded_triangular_solve_grad():
    from magi_v2_tpu.ops.banded import (
        banded_to_blocks_upper,
        block_banded_triangular_solve_upper,
        dense_to_banded,
    )

    rng = np.random.default_rng(3)
    N, b = 100, 11
    A = random_spd_banded(rng, N, b)
    U_band, _ = banded_cholesky_upper(dense_to_banded_np(A, b))
    U = band_to_dense(U_band)
    blocks = banded_to_blocks_upper(jnp.asarray(dense_to_banded(U, b)))
    v = jnp.asarray(rng.standard_normal(N))

    f = lambda y: jnp.sum(
        v * block_banded_triangular_solve_upper(blocks, y)
    )
    y0 = jnp.asarray(rng.standard_normal(N))
    g = np.asarray(jax.grad(f)(y0))
    # d/dy v' U^{-1} y = U^{-T} v
    ref = np.linalg.solve(U.T, np.asarray(v))
    np.testing.assert_allclose(g, ref, atol=1e-8 * np.abs(ref).max())


def test_block_banded_matvec_upper_matches_symmetric():
    from magi_v2_tpu.ops.banded import (
        banded_to_blocks,
        banded_to_blocks_upper,
        block_banded_matvec,
        block_banded_matvec_upper,
        dense_to_banded,
    )

    rng = np.random.default_rng(6)
    N, b = 300, 37
    U = np.triu(rng.standard_normal((N, N)))
    i, j = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    U = np.where((j - i <= b) & (j >= i), U, 0.0)
    band = dense_to_banded(jnp.asarray(U), b)
    x = rng.standard_normal((5, N))  # batched leading dim
    y_sym = block_banded_matvec(banded_to_blocks(band), jnp.asarray(x))
    y_up = block_banded_matvec_upper(
        banded_to_blocks_upper(band), jnp.asarray(x)
    )
    np.testing.assert_allclose(np.asarray(y_up), np.asarray(y_sym), atol=1e-12)
    np.testing.assert_allclose(np.asarray(y_up), x @ U.T, atol=1e-10)


def test_gn_precision_band_matches_dense():
    from magi_v2_tpu.sampler.precond import (
        gauss_newton_precision,
        gauss_newton_precision_band,
    )

    rng = np.random.default_rng(5)
    N, D = 11, 3

    def spd(n):
        a = rng.standard_normal((n, n))
        return a @ a.T + n * np.eye(n)

    C_invs = np.stack([spd(N) for _ in range(D)])
    K_invs = np.stack([spd(N) for _ in range(D)])
    m_ds = rng.standard_normal((D, N, N))
    J = rng.standard_normal((N, D, D))
    beta, sigma = 1.7, np.array([0.1, 0.2, 0.3])
    obs_mask = (rng.uniform(size=(N, D)) > 0.3).astype(float)

    lam_dense = np.asarray(
        gauss_newton_precision(
            C_invs, m_ds, K_invs, beta, obs_mask, sigma, jnp.asarray(J)
        )
    )
    lam_band = band_to_dense(
        gauss_newton_precision_band(
            C_invs, m_ds, K_invs, beta, obs_mask, sigma, J, bw=N * D - 1
        )
    )
    np.testing.assert_allclose(lam_band, lam_dense, atol=1e-10 * np.abs(lam_dense).max())


# ---------------------------------------------------------------------------
# End-to-end: the banded-precond sampler path on a small SEIR problem
# ---------------------------------------------------------------------------


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


def test_banded_centered_equals_banded_precond_target(small_seir_model):
    """Centered and GN-whitened banded modes must evaluate the SAME
    tempered log-posterior at corresponding points (the reparameterization
    is a linear coordinate change with constant Jacobian)."""
    from magi_v2_tpu.ops.banded import banded_to_blocks_upper
    from magi_v2_tpu.posterior import make_posterior_data, to_banded_data
    from magi_v2_tpu.sampler.magi_state import (
        flatten_state,
        make_tempered_logp_grad,
    )
    from magi_v2_tpu.sampler.precond import (
        build_gn_cholesky_banded,
        make_tempered_logp_grad_gn_banded,
        whiten_X_banded,
    )
    from magi_v2_tpu.models import seir_f_vec

    from magi_v2_tpu.ops.linalg import sym_sqrt

    m = small_seir_model
    dtype = jnp.float64
    sigma_LB = np.full(m.D, 1e-6)
    data = make_posterior_data(
        m.I, m.C_d_invs, m.m_ds, m.K_d_invs, m.mu_ds, m.beta,
        m.obs_index, sigma_LB, dtype,
    )
    R64 = np.asarray(sym_sqrt(jnp.asarray(m.C_d_invs)))
    S64 = np.asarray(sym_sqrt(jnp.asarray(m.K_d_invs)))
    bdata = to_banded_data(
        data, m.BANDSIZE, C_inv_sqrts_f64=R64, K_inv_sqrts_f64=S64
    )
    U_band, info = build_gn_cholesky_banded(
        m, C_inv_sqrts=R64, K_inv_sqrts=S64
    )
    assert info["jitter"] == 0.0  # PSD by construction from the factors
    U_blocks = jnp.asarray(banded_to_blocks_upper(jnp.asarray(U_band)), dtype)

    lp_cent = make_tempered_logp_grad(bdata, seir_f_vec, m.mag_I, m.D, 3)
    lp_gn = make_tempered_logp_grad_gn_banded(
        bdata, seir_f_vec, U_blocks, m.mag_I, m.D, 3
    )

    rng = np.random.default_rng(0)
    X = m.Xhat_init + 0.02 * rng.standard_normal(m.Xhat_init.shape)
    sig = jnp.asarray(rng.standard_normal(m.D) * 0.1 - 2.0, dtype)
    th = jnp.asarray(rng.standard_normal(3) * 0.1 + 1.0, dtype)
    Z = np.asarray(whiten_X_banded(jnp.asarray(X), jnp.asarray(m.mu_ds),
                                   U_blocks))

    q_cent = flatten_state(jnp.asarray(X, dtype), sig, th)
    q_gn = flatten_state(jnp.asarray(Z, dtype), sig, th)
    bt = jnp.asarray(0.7, dtype)
    v_cent, _ = lp_cent(q_cent, bt)
    v_gn, g_gn = lp_gn(q_gn, bt)
    # W z reproduces X up to the f64 solve/matvec roundtrip
    np.testing.assert_allclose(float(v_gn), float(v_cent), rtol=1e-8)
    assert np.all(np.isfinite(np.asarray(g_gn)))


def test_predict_banded_precond_end_to_end(small_seir_model):
    res = small_seir_model.predict(
        num_results=40,
        num_burnin_steps=40,
        num_chains=2,
        seed=0,
        storage="banded",
        reparam="precond",
    )
    th = res["thetas_samps"].reshape(-1, 3)
    assert np.all(np.isfinite(th))
    assert np.all(np.isfinite(res["X_samps"]))
    # loose sanity: theta stays in the right ballpark from a good init
    assert np.abs(np.median(th, axis=0) - np.array([6.0, 0.6, 1.8])).max() < 2.0


def test_predict_banded_centered_still_works(small_seir_model):
    res = small_seir_model.predict(
        num_results=10,
        num_burnin_steps=10,
        num_chains=1,
        storage="banded",
        reparam="centered",
    )
    assert np.all(np.isfinite(res["thetas_samps"]))


def test_predict_banded_whitened_rejected(small_seir_model):
    with pytest.raises(ValueError):
        small_seir_model.predict(
            num_results=2, num_burnin_steps=2,
            storage="banded", reparam="whitened",
        )


@pytest.mark.parametrize("restart", ["remap", "laplace"])
def test_predict_banded_precond_refresh(small_seir_model, restart):
    """Mid-warmup preconditioner refresh: re-anchors the GN factor at the
    chain-median state, then restarts stage B either by exact linear remap
    of the chain states or from the Gauss-Newton Laplace approximation at
    the refreshed anchor. The feature is experimental and measured
    harmful at dense-grid scale (DEVIATIONS #22) — this test pins the
    mechanics at small scale: the posterior is unchanged and sampling
    stays sane under both restart modes."""
    res = small_seir_model.predict(
        num_results=40,
        num_burnin_steps=40,
        num_chains=2,
        seed=0,
        storage="banded",
        reparam="precond",
        precond_refresh_steps=20,
        precond_refresh_restart=restart,
    )
    th = res["thetas_samps"].reshape(-1, 3)
    assert np.all(np.isfinite(th))
    assert np.all(np.isfinite(res["X_samps"]))
    assert np.abs(np.median(th, axis=0) - np.array([6.0, 0.6, 1.8])).max() < 2.0
