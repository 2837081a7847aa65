"""Lorenz N_I=1025 exact-posterior MAP + Laplace — the accurate beta=1
dense-grid answer (BASELINE.json configs[4] accuracy bar: "theta within
1%, trajectory CI overlap").

Complement to scripts/lorenz1025_long.py: the sampled recipe targets a
band-truncated approximation (adjudicated round 4, DEVIATIONS.md #25,
results/lorenz_joint_map_probe.json) and exact-posterior HMC is eps-collapsed at this
grid density, but the exact posterior's joint mode is at truth and a
whitened L-BFGS-B reaches it in minutes on CPU f64. This script runs the
productized MAGI_v2.map_estimate() at the acceptance config and records
theta accuracy, Laplace z-scores, and 95% Laplace-interval trajectory
coverage vs the noiseless truth.

Writes results/lorenz1025_map.json.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--precondition", default="gn",
                    choices=["gn", "prior"],
                    help="map_estimate whitening (gn: banded Gauss-Newton "
                         "factor, round-5 default; prior: the round-4 "
                         "C^{1/2} path, 27,442 iters / 1100 s)")
    ap.add_argument("--out", default="results/lorenz1025_map.json")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from magi_v2_tpu import MAGI_v2
    from magi_v2_tpu.models import lorenz_f_vec
    from magi_v2_tpu.utils.data import simulate_ode

    true = np.array([10.0, 28.0, 8.0 / 3.0])
    ts_obs, X_obs, _ = simulate_ode(
        lorenz_f_vec, x0=np.array([-8.0, 7.0, 27.0]), thetas=true,
        t_max=2.0, n_obs=257, noise_sd=0.5, substeps=50,
    )
    # bandsize=100 exactly like the sampled recipe: map_estimate must
    # bypass the truncation itself (band_truncation_bypassed=True)
    model = MAGI_v2(D_thetas=3, ts_obs=ts_obs, X_obs=X_obs, bandsize=100,
                    f_vec=lorenz_f_vec)
    t0 = time.time()
    model.initial_fit(discretization=2)
    setup_s = time.time() - t0
    _, _, X_true = simulate_ode(
        lorenz_f_vec, x0=np.array([-8.0, 7.0, 27.0]), thetas=true,
        t_max=2.0, n_obs=model.mag_I, noise_sd=0.0, substeps=50,
    )

    r = model.map_estimate(sigma_sqs_fixed=0.25, verbose=True,
                           precondition=args.precondition)

    lo = r["X_map"] - 1.96 * r["X_sd"]
    hi = r["X_map"] + 1.96 * r["X_sd"]
    inside = (X_true >= lo) & (X_true <= hi)
    out = {
        "config": ("Lorenz N_I=1025 (257 obs, disc=2, noise 0.5, sigma "
                   "fixed 0.25), MAGI_v2.map_estimate(): exact-operator "
                   "beta=1 MAP + Laplace, CPU f64"),
        "theta_map": np.round(r["theta_map"], 4).tolist(),
        "theta_true": true.tolist(),
        "theta_rel_err": np.round(
            (r["theta_map"] - true) / true, 4).tolist(),
        "theta_sd_laplace": np.round(r["theta_sd"], 4).tolist(),
        "theta_z_vs_truth": np.round(
            (r["theta_map"] - true) / r["theta_sd"], 2).tolist(),
        "traj_coverage_95_laplace": round(float(inside.mean()), 4),
        "traj_coverage_95_per_comp": [
            round(float(c), 4) for c in inside.mean(axis=0)],
        "X_rmse_vs_truth": round(
            float(np.sqrt(((r["X_map"] - X_true) ** 2).mean())), 4),
        "neg_logpost": r["neg_logpost"],
        "grad_norm": r["grad_norm"],
        "precondition": r["precondition"],
        "lbfgs_iters": r["lbfgs_iters"],
        "converged": r["converged"],
        "hessian_spd": r["hessian_spd"],
        "band_truncation_bypassed": r["band_truncation_bypassed"],
        "band_truncation_of_model": model.band_truncation,
        "map_wall_s": round(r["wall_s"], 1),
        "setup_s": round(setup_s, 1),
        "vs_sampled_recipe": {
            "run": "results/lorenz1025_r3j.json (tempered b=100)",
            "theta_rel_err": [-0.1046, -0.0316, -0.1132],
            "traj_coverage_95": 0.1375,
        },
    }
    os.makedirs("results", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
