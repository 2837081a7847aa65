"""Banded precision operators vs dense oracles (plain jnp/lax; no
hand-written kernel — the same code runs on the CPU and the GPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from magi_v2_tpu.ops.banded import (
    banded_matvec,
    banded_quadratic_form,
    banded_to_dense,
    dense_to_banded,
    transpose_band,
)
from magi_v2_tpu.ops.linalg import band_part


def _random_banded_dense(N, b, seed=0, batch=()):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=batch + (N, N))
    return np.asarray(band_part(jnp.asarray(A), b, b))


def test_roundtrip_dense_banded():
    A = _random_banded_dense(17, 3)
    band = dense_to_banded(A, 3)
    assert band.shape == (7, 17)
    np.testing.assert_allclose(banded_to_dense(band), A)


def test_matvec_matches_dense():
    N, b = 33, 5
    A = _random_banded_dense(N, b, seed=1)
    x = np.random.default_rng(2).normal(size=(N,))
    band = dense_to_banded(A, b)
    np.testing.assert_allclose(
        np.asarray(banded_matvec(band, jnp.asarray(x))), A @ x, rtol=1e-12
    )


def test_matvec_batched():
    N, b, D = 21, 4, 3
    A = _random_banded_dense(N, b, seed=3, batch=(D,))
    x = np.random.default_rng(4).normal(size=(D, N))
    band = dense_to_banded(A, b)
    expect = np.einsum("dnm,dm->dn", A, x)
    np.testing.assert_allclose(
        np.asarray(banded_matvec(band, jnp.asarray(x))), expect, rtol=1e-12
    )


def test_transpose_band():
    N, b = 19, 3
    A = _random_banded_dense(N, b, seed=5)
    band = dense_to_banded(A, b)
    np.testing.assert_allclose(
        banded_to_dense(np.asarray(transpose_band(band))), A.T, atol=1e-14
    )


def test_quadratic_form_and_gradients():
    N, b = 25, 4
    A = _random_banded_dense(N, b, seed=6)
    A = A + A.T  # symmetric
    band = jnp.asarray(dense_to_banded(A, b))
    x = jnp.asarray(np.random.default_rng(7).normal(size=(N,)))

    q = float(banded_quadratic_form(band, x))
    np.testing.assert_allclose(q, np.asarray(x) @ A @ np.asarray(x), rtol=1e-12)

    # grad wrt x: (A + A^T) x = 2 A x for symmetric A
    g = jax.grad(lambda xx: banded_quadratic_form(band, xx))(x)
    np.testing.assert_allclose(np.asarray(g), 2 * A @ np.asarray(x), rtol=1e-10)

    # grad wrt band entries: finite-difference spot check
    f = lambda bb: banded_quadratic_form(bb, x)
    gb = jax.grad(f)(band)
    h = 1e-6
    e = jnp.zeros_like(band).at[4, 10].set(h)
    fd = (float(f(band + e)) - float(f(band - e))) / (2 * h)
    np.testing.assert_allclose(float(gb[4, 10]), fd, rtol=1e-5)


def test_jit_and_vmap():
    N, b, C = 15, 2, 4
    A = _random_banded_dense(N, b, seed=8)
    band = jnp.asarray(dense_to_banded(A, b))
    xs = jnp.asarray(np.random.default_rng(9).normal(size=(C, N)))
    out = jax.jit(jax.vmap(lambda x: banded_matvec(band, x)))(xs)
    expect = np.asarray(xs) @ A.T
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-12)


def test_banded_posterior_matches_dense_when_band_covers_matrix():
    """Banded log-posterior == dense when bandwidth >= N-1."""
    from magi_v2_tpu import preprocess
    from magi_v2_tpu.models import seir_f_vec
    from magi_v2_tpu.posterior import (
        make_log_posterior, make_posterior_data, to_banded_data,
    )

    rng = np.random.default_rng(11)
    N, D = 13, 3
    I = np.linspace(0, 1, N).reshape(-1, 1)
    X_obs = rng.normal(size=(N, D)) * 0.1
    X_obs[rng.random(X_obs.shape) < 0.3] = np.nan
    obs = preprocess.build_observation_index(X_obs)

    def spd():
        a = rng.normal(size=(N, N))
        return a @ a.T / N + np.eye(N)

    data = make_posterior_data(
        I, np.stack([spd() for _ in range(D)]),
        np.stack([rng.normal(size=(N, N)) for _ in range(D)]),
        np.stack([spd() for _ in range(D)]),
        rng.normal(size=D), 1.5, obs, np.full(D, 1e-4), jnp.float64,
    )
    banded = to_banded_data(data, N - 1)
    lp_d = make_log_posterior(data, seir_f_vec)
    lp_b = make_log_posterior(banded, seir_f_vec)
    X = jnp.asarray(rng.normal(size=(N, D)))
    s, t = jnp.asarray(rng.normal(size=D)), jnp.asarray(rng.normal(size=3))
    v_d = float(lp_d(X, s, t, 0.7))
    v_b = float(lp_b(X, s, t, 0.7))
    np.testing.assert_allclose(v_b, v_d, rtol=1e-12)
    # gradients agree too
    g_d = jax.grad(lp_d)(X, s, t, 0.7)
    g_b = jax.grad(lp_b)(X, s, t, 0.7)
    np.testing.assert_allclose(np.asarray(g_b), np.asarray(g_d), rtol=1e-10)


def test_block_banded_matches_dense():
    from magi_v2_tpu.ops.banded import banded_to_blocks, block_banded_matvec

    rng = np.random.default_rng(30)
    for N, b in [(33, 5), (200, 60), (300, 140)]:
        A = _random_banded_dense(N, b, seed=N)
        x = rng.normal(size=(N,))
        blocks = banded_to_blocks(jnp.asarray(dense_to_banded(A, b)))
        y = np.asarray(block_banded_matvec(blocks, jnp.asarray(x)))
        np.testing.assert_allclose(y, A @ x, rtol=1e-11, atol=1e-12)


def test_block_banded_batched_and_grad():
    from magi_v2_tpu.ops.banded import (
        banded_to_blocks, block_banded_matvec, block_banded_quadratic_form,
    )

    rng = np.random.default_rng(31)
    N, b, D, C = 150, 40, 3, 4
    A = _random_banded_dense(N, b, seed=7, batch=(D,))
    blocks = banded_to_blocks(jnp.asarray(dense_to_banded(A, b)))
    x = jnp.asarray(rng.normal(size=(D, N)))
    y = np.asarray(block_banded_matvec(blocks, x))
    np.testing.assert_allclose(y, np.einsum("dnm,dm->dn", A, np.asarray(x)),
                               rtol=1e-11)
    # vmap over chains
    xs = jnp.asarray(rng.normal(size=(C, D, N)))
    ys = np.asarray(jax.vmap(lambda xx: block_banded_matvec(blocks, xx))(xs))
    np.testing.assert_allclose(
        ys, np.einsum("dnm,cdm->cdn", A, np.asarray(xs)), rtol=1e-11
    )
    # gradient: symmetric A -> grad of quad form = 2 A x
    As = A + np.swapaxes(A, -1, -2)
    blocks_s = banded_to_blocks(jnp.asarray(dense_to_banded(As, b)))
    g = jax.grad(lambda xx: block_banded_quadratic_form(blocks_s, xx))(x)
    np.testing.assert_allclose(np.asarray(g),
                               2 * np.einsum("dnm,dm->dn", As, np.asarray(x)),
                               rtol=1e-10)
