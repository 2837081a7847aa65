"""Dataset utilities: the reference SEIR CSV loader and a self-contained ODE
simulator (RK4 + Gaussian noise) so every benchmark system has data without
external files.

The reference ships 21 SEIR CSVs (data/*.csv: columns
t, {S,E,I,R}_obs, {S,E,I,R}_true; 10001 rows over t in [0,10]) and thins
them in the vignette (vignette.ipynb cell 5): keep t <= t_max, subsample to
d_obs observations per unit time.
"""

from __future__ import annotations

import os

import numpy as np

REFERENCE_DATA_DIR = "/root/reference/data"


def load_seir_csv(
    path: str | None = None,
    d_obs: int = 20,
    t_max: float = 4.0,
    comp_obs=(True, True, True),
):
    """Load + thin a reference SEIR CSV exactly like vignette.ipynb cell 5.

    Returns (ts_obs (N,), X_obs (N,3) with NaN for unobserved components,
    raw dict with true trajectories for evaluation).
    """
    import csv

    if path is None:
        path = os.path.join(REFERENCE_DATA_DIR, "SEIR_seed=0.csv")
    with open(path) as fh:
        reader = csv.reader(fh)
        header = next(reader)
        rows = np.array([[float(v) for v in row] for row in reader])
    col = {name: i for i, name in enumerate(header)}

    t = rows[:, col["t"]]
    keep = t <= t_max
    rows = rows[keep]
    t = t[keep]

    stride = int((rows.shape[0] - 1) / (d_obs * t_max))
    obs = rows[::stride]
    ts_obs = obs[:, col["t"]].astype(np.float64)
    X_obs = obs[:, [col["E_obs"], col["I_obs"], col["R_obs"]]].astype(np.float64)
    X_obs[X_obs < 0.0] = 0.0
    for i, is_obs in enumerate(comp_obs):
        if not is_obs:
            X_obs[:, i] = np.nan

    raw = {
        "t": t,
        "X_true": rows[:, [col["E_true"], col["I_true"], col["R_true"]]],
    }
    return ts_obs, X_obs, raw


def simulate_ode(
    f_vec,
    x0: np.ndarray,
    thetas: np.ndarray,
    t_max: float,
    n_obs: int,
    noise_sd,
    seed: int = 0,
    substeps: int = 100,
    comp_obs=None,
):
    """Integrate dX/dt = f_vec(t, X, thetas) with RK4 and add iid Gaussian
    noise — generates data for any model in magi_v2_tpu.models.

    f_vec follows the library contract (t (N,1), X (N,D), thetas) -> (N,D);
    here it is evaluated on single rows. Returns (ts (n_obs,),
    X_obs (n_obs, D) noisy [NaN for unobserved components], X_true).
    """
    import jax
    import jax.numpy as jnp

    x0 = np.asarray(x0, np.float64)
    D = x0.shape[0]
    ts = np.linspace(0.0, t_max, n_obs)
    h = (t_max / (n_obs - 1)) / substeps

    # One jitted lax.scan on CPU: a Python RK4 loop would eagerly dispatch
    # ~1e6 tiny ops, each its own device launch on an accelerator.
    with jax.default_device(jax.devices("cpu")[0]):
        thetas_j = jnp.asarray(thetas)

        def f(t, x):
            return f_vec(t[None, None], x[None, :], thetas_j)[0]

        def substep(x, t):
            k1 = f(t, x)
            k2 = f(t + h / 2, x + h / 2 * k1)
            k3 = f(t + h / 2, x + h / 2 * k2)
            k4 = f(t + h, x + h * k3)
            return x + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4), None

        def obs_step(x, t0):
            x, _ = jax.lax.scan(substep, x, t0 + h * jnp.arange(substeps))
            return x, x

        @jax.jit
        def integrate(x0):
            return jax.lax.scan(obs_step, x0, jnp.asarray(ts[:-1]))[1]

        X_rest = np.asarray(integrate(jnp.asarray(x0)))
    X_true = np.concatenate([x0[None, :], X_rest], axis=0)

    rng = np.random.default_rng(seed)
    noise_sd = np.broadcast_to(np.asarray(noise_sd, np.float64), (D,))
    X_obs = X_true + rng.standard_normal(X_true.shape) * noise_sd
    if comp_obs is not None:
        for d, is_obs in enumerate(comp_obs):
            if not is_obs:
                X_obs[:, d] = np.nan
    return ts, X_obs, X_true
