"""Measure the posterior correlation structure the SEIR bench sampler sees.

Motivation: the bench needs HMC L=192 because the slowest theta component
only decorrelates with long trajectories (ESS_min 829 at L64 -> 18k at
L192, results/seir_dense_mass_probe.json). A diagonal mass matrix cannot rotate
correlated ridges; this probe quantifies how correlated the sampling-space
tail block (sigma_sqs_pre, thetas_pre) is and how strongly theta couples
to the trajectory block — the go/no-go measurement for a dense tail-block
mass matrix option.

Runs the exact bench geometry (SEIR vignette, N_I=161, 256 chains, HMC
L192, warmup_only so the measured target is the true posterior), then
prints the tail-block correlation matrix and the max |corr| between each
theta and the X block, in PRE (unconstrained) space.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def inv_softplus(y):
    # stable log(expm1(y))
    return np.where(y > 30, y, np.log(np.expm1(np.maximum(y, 1e-12))))


def main():
    import jax

    from magi_v2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu.models import seir_f_vec
    from magi_v2_tpu.utils.data import load_seir_csv

    ts_obs, X_obs, _ = load_seir_csv(t_max=4.0, d_obs=20)
    cfg = MagiConfig().replace(dtype=jnp.float32)
    model = MAGI_v2(D_thetas=3, ts_obs=ts_obs, X_obs=X_obs, bandsize=80,
                    f_vec=seir_f_vec, config=cfg)
    model.initial_fit(discretization=1)

    t0 = time.time()
    res = model.predict(
        num_results=1000, num_burnin_steps=1000, num_chains=256, seed=0,
        init_jitter=0.01, algorithm="hmc", hmc_num_leapfrogs=192,
        anneal_mode="warmup_only",
    )
    wall = time.time() - t0

    # constrained draws -> pre space (the sampler's coordinates for the
    # tail block; softplus is monotone so correlations barely move, but
    # measure where the mass matrix acts)
    th = np.asarray(res["thetas_samps"])          # (T, C, 3)
    sg = np.asarray(res["sigma_sqs_samps"])       # (T, C, 3)
    X = np.asarray(res["X_samps"])                # (T, C, N_I, 3)
    th_pre = inv_softplus(th)
    sgLB = float(np.min(sg)) * 0.0  # sigma pre offset irrelevant for corr
    sg_pre = inv_softplus(np.maximum(sg - sgLB, 1e-12))

    T, C = th.shape[:2]
    tail = np.concatenate([sg_pre.reshape(T * C, -1),
                           th_pre.reshape(T * C, -1)], axis=1)
    corr_tail = np.corrcoef(tail, rowvar=False)

    # theta <-> X coupling: max |corr| over all grid points/components
    Xf = X.reshape(T * C, -1)
    xc = Xf - Xf.mean(0)
    xs = xc / (xc.std(0) + 1e-12)
    out = {}
    for j in range(3):
        t = tail[:, 3 + j] - tail[:, 3 + j].mean()
        t = t / (t.std() + 1e-12)
        cmax = float(np.max(np.abs(xs.T @ t)) / (T * C))
        out[f"theta{j}_max_abs_corr_with_X"] = round(cmax, 4)

    # top eigenvector of the tail correlation: how elongated is the ridge?
    w, V = np.linalg.eigh(corr_tail)
    report = {
        "wall_s": round(wall, 1),
        "rhat_note": "see bench for convergence; this probe reuses its config",
        "corr_tail_rounded": np.round(corr_tail, 3).tolist(),
        "tail_corr_eigvals": np.round(w, 4).tolist(),
        "tail_corr_top_vec": np.round(V[:, -1], 3).tolist(),
        "condition_number_tail_corr": round(float(w[-1] / max(w[0], 1e-12)), 2),
        **out,
    }
    print(json.dumps(report))
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "results", "seir_corr_probe.json"), "w") as fh:
        json.dump(report, fh, indent=1)


if __name__ == "__main__":
    main()
