"""Whitened-curvature stiffness probe for the dense-grid hybrid recipe.

Both N_I=2049 hybrid runs (b=100 600+300, b=200 2000+500 — results/
lorenz2049_hybrid_probe.json, lorenz2049_hybrid_diag2.json) eps-collapsed
(frozen chains, rhat ~1e148) under the exact recipe that converges at
N_I=1025 (results/lorenz1025_hybrid_f03_long_r5.json, eps 0.165). This
probe measures WHY, without accelerator hours: the largest eigenvalue of
the NEGATIVE Hessian of the whitened tempered log-posterior at the chain
init point, via Hessian-vector-product power iteration (f64, CPU). A
leapfrog integrator is stable only for eps <~ 2/sqrt(lambda_max), so
lambda_max directly predicts the adapted step size; comparing it across
(N_I, bandsize, beta_temp) separates the candidate causes:

  - banded-GN truncation (off-band curvature left unwhitened) -> wider
    band helps -> lambda_max(b=400) << lambda_max(b=200)
  - intrinsic h^-4 manifold stiffness the GN linearization misses ->
    band-independent, beta-scaling
"""

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/stiffness_probe.json")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    # x64 stays OFF globally, mirroring the f32 sampling process: the
    # library's setup runs under its own scoped enable_x64, and the theta
    # initializer's Adam trajectory is dtype-sensitive at disc=3 (f32 env
    # lands (9.02, 30.44, 3.15); a global-x64 env lands (-3.4, 35.9,
    # -122.0) — BOTH far from truth, see the f32 row's lp at init).
    import jax.numpy as jnp

    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu.models import lorenz_f_vec
    from magi_v2_tpu.utils.data import simulate_ode
    from magi_v2_tpu.sampler.magi_state import flatten_state
    from magi_v2_tpu.posterior import softplus_inverse

    true = np.array([10.0, 28.0, 8.0 / 3.0])
    ts_obs, X_obs, _ = simulate_ode(
        lorenz_f_vec, x0=np.array([-8.0, 7.0, 27.0]), thetas=true,
        t_max=2.0, n_obs=257, noise_sd=0.5, substeps=50,
    )

    def pre_init(vals, lower):
        # predict()'s unconstrained init (api.py): inverse-softplus where
        # above the bound, else -5.0 (NEVER softplus_inverse of a negative
        # value — at N_I=2049 the f64-config gradient-matching init lands
        # at thetas (-3.4, 35.9, -122.0) and the naive transform is NaN)
        out = np.full_like(np.asarray(vals, np.float64), -5.0)
        above = np.asarray(vals) > lower
        out[above] = np.asarray(
            softplus_inverse(jnp.asarray(np.asarray(vals)[above]
                                         - lower[above])))
        return out

    def lam_max(mode_lp, q0, beta, iters=120, seed=0):
        """Power iteration on -H of lp at q0 (forward-over-reverse HVP)."""
        g = lambda q: mode_lp(q, jnp.asarray(beta, q0.dtype))[1]
        hvp = jax.jit(lambda v: -jax.jvp(g, (q0,), (v,))[1])
        rng = np.random.default_rng(seed)
        v = jnp.asarray(rng.standard_normal(q0.shape), q0.dtype)
        v = v / jnp.linalg.norm(v)
        lam = 0.0
        for _ in range(iters):
            w = hvp(v)
            lam = float(v @ w)
            nw = jnp.linalg.norm(w)
            v = w / nw
        return lam

    results = []
    for disc, b in [(2, 100), (3, 100), (3, 200), (3, 400)]:
        # mirror scripts/lorenz1025_long.py: f32 sampling dtype (setup
        # still runs f64 on CPU); the accelerator failure reproduces in f32 on CPU
        cfg = MagiConfig().replace(dtype=jnp.float32)
        model = MAGI_v2(D_thetas=3, ts_obs=ts_obs, X_obs=X_obs,
                        bandsize=b, f_vec=lorenz_f_vec, config=cfg)
        t0 = time.time()
        model.initial_fit(discretization=disc, verbose=False)
        setup_s = time.time() - t0
        dtype = cfg.dtype
        mode, data, sigma_sqs_LB, sig_fix64, _pre_fix = (
            model._build_sampling_setup(
                "precond", "hybrid", dtype, sigma_sqs_fixed=0.25,
            )
        )
        theta_pre0 = pre_init(model.thetas_init,
                              np.zeros_like(model.thetas_init))
        q0 = jnp.asarray(flatten_state(
            mode.X0, jnp.asarray(_pre_fix, dtype),
            jnp.asarray(theta_pre0, dtype),
        ))
        row = {"N_I": int(model.mag_I), "bandsize": b,
               "dim": int(q0.shape[0]), "setup_s": round(setup_s, 1),
               "theta_init": [round(float(v), 3)
                              for v in model.thetas_init],
               "lp_q0_beta0.3": round(float(
                   mode.logp_grad(q0, jnp.asarray(0.3, dtype))[0]), 2),
               "band_truncation": {
                   k: round(float(v), 4)
                   for k, v in getattr(model, "band_truncation", {}).items()
               }}
        for beta in (0.15, 0.3, 1.0):
            t0 = time.time()
            lam = lam_max(mode.logp_grad, q0, beta)
            row[f"lam_max_beta{beta}"] = float(f"{lam:.4g}")
            row[f"eps_stable_beta{beta}"] = float(f"{2.0 / np.sqrt(max(lam, 1e-300)):.4g}")
            row[f"probe_s_beta{beta}"] = round(time.time() - t0, 1)
        print(json.dumps(row), flush=True)
        results.append(row)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
