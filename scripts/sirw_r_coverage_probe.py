"""Adjudicate the SIRW R-component coverage miss (calibration table:
per-comp [1.0, 1.0, 0.6708, 1.0] at the true-posterior cell).

Same yardstick as the SEIR R-offset and Hes1-H adjudications: if the
sampled 95% band covers the ODE trajectory integrated at the SAMPLED
posterior mean (theta, x0) while missing the truth, the miss is a
posterior-intrinsic offset at tight CIs (the posterior's preferred
trajectory differs slightly from the noiseless truth), not sampler error.
SEIR's R component showed exactly this, independently validated against a
SciPy transliteration (results/r_offset_validation.json).

Writes results/sirw_r_coverage_probe.json.
"""

import json
import os
import time

import numpy as np


def main():
    import jax

    from magi_v2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu.models import sirw_f_vec
    from magi_v2_tpu.utils import summarize_chains
    from magi_v2_tpu.utils.data import simulate_ode

    theta_true = np.array([4.0, 1.0, 0.3, 0.5, 0.2])
    x0 = np.array([0.95, 0.05, 0.0, 0.0])
    ts_obs, X_obs, _ = simulate_ode(
        sirw_f_vec, x0=x0, thetas=theta_true, t_max=8.0, n_obs=81,
        noise_sd=0.01)
    cfg = MagiConfig().replace(dtype=jnp.float32)
    model = MAGI_v2(D_thetas=5, ts_obs=ts_obs, X_obs=X_obs, bandsize=200,
                    f_vec=sirw_f_vec, config=cfg)
    model.initial_fit(discretization=1)
    _, _, X_true = simulate_ode(
        sirw_f_vec, x0=x0, thetas=theta_true, t_max=8.0, n_obs=model.mag_I,
        noise_sd=0.0)

    t0 = time.time()
    res = model.predict(
        num_results=1000, num_burnin_steps=2000, num_chains=256, seed=0,
        init_jitter=0.01, algorithm="hmc", hmc_num_leapfrogs=192,
        anneal_mode="warmup_only", mass_matrix="auto", verbose=True)
    wall = time.time() - t0

    X = np.asarray(res["X_samps"], np.float64)
    flat = X.reshape(-1, *X_true.shape)
    lo, hi = np.quantile(flat, [0.025, 0.975], axis=0)
    cov_truth = ((X_true >= lo) & (X_true <= hi)).mean(axis=0)

    # self-consistent trajectory at the sampled posterior mean
    th_mean = np.asarray(res["thetas_samps"], np.float64).reshape(-1, 5).mean(0)
    x0_mean = flat.mean(axis=0)[0]
    _, _, X_self = simulate_ode(
        sirw_f_vec, x0=x0_mean, thetas=th_mean, t_max=8.0,
        n_obs=model.mag_I, noise_sd=0.0)
    cov_self = ((X_self >= lo) & (X_self <= hi)).mean(axis=0)

    mu, sd = flat.mean(axis=0), flat.std(axis=0)
    z_truth = (X_true - mu) / np.maximum(sd, 1e-12)
    s = summarize_chains(res["thetas_samps"], wall)

    out = {
        "config": ("SIRW N_I=161, 256 x 2000+1000 HMC L=192 dense 'auto' "
                   "metric, warmup_only (true posterior), f32"),
        "components": ["S", "I", "R", "W"],
        "coverage_95_vs_truth_per_comp": [round(float(c), 4)
                                          for c in cov_truth],
        "coverage_95_vs_self_consistent_ode_per_comp": [
            round(float(c), 4) for c in cov_self],
        "z_truth_abs_max_per_comp": [round(float(a), 2)
                                     for a in np.abs(z_truth).max(axis=0)],
        "mean_ci_width_per_comp": [round(float(w), 5)
                                   for w in (hi - lo).mean(axis=0)],
        "theta_mean": [round(float(v), 4) for v in th_mean],
        "theta_true": theta_true.tolist(),
        "ess_min": round(s["ess_min"], 1),
        "rhat_max": round(s["rhat_max"], 4),
        "wall_s": round(wall, 1),
        "device": str(jax.devices()[0].device_kind),
    }
    os.makedirs("results", exist_ok=True)
    with open("results/sirw_r_coverage_probe.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
