"""Measure the dense mass matrix's effect on the SEIR bench operating point.

The bench runs HMC L=192 because that is the diagonal-metric decorrelation
threshold of the slowest theta component (ESS_min 829 at L64 -> 18038 at
L192). The X-theta ridge (|corr| up to 0.89, results/seir_corr_probe.json)
is what a diagonal cannot rotate; mass_matrix='dense' estimates the full
flat-state covariance in the Welford window. If theta decorrelates at
L=64 under the dense metric, the bench headline gains ~3x wall.

Grid: (mass_matrix, L) cells, each 256 chains x 1000+1000 warmup_only HMC
(the true-posterior config — rhat/ESS are comparable across cells).
Prints one JSON line per cell and writes results/seir_dense_mass_probe.json.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from magi_v2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu.models import seir_f_vec
    from magi_v2_tpu.utils import summarize_chains
    from magi_v2_tpu.utils.data import load_seir_csv

    ts_obs, X_obs, _ = load_seir_csv(t_max=4.0, d_obs=20)
    cfg = MagiConfig().replace(dtype=jnp.float32)
    model = MAGI_v2(D_thetas=3, ts_obs=ts_obs, X_obs=X_obs, bandsize=80,
                    f_vec=seir_f_vec, config=cfg)
    model.initial_fit(discretization=1)

    # cells from argv ("dense:96,dense:160") or the original default grid
    if len(sys.argv) > 1:
        cells = [(m, int(L)) for m, L in
                 (c.split(":") for c in sys.argv[1].split(","))]
    else:
        cells = [
            ("dense", 64),
            ("dense", 32),
            ("diag", 64),       # diagonal reference at the same L
            ("dense", 128),
        ]
    out = {}
    for mass, L in cells:
        t0 = time.time()
        res = model.predict(
            num_results=1000, num_burnin_steps=1000, num_chains=256,
            seed=0, init_jitter=0.01, algorithm="hmc",
            hmc_num_leapfrogs=L, anneal_mode="warmup_only",
            mass_matrix=mass,
        )
        wall = time.time() - t0
        s = summarize_chains(res["thetas_samps"], wall)
        theta = np.asarray(res["thetas_samps"]).reshape(-1, 3).mean(0)
        cell = {
            "wall_s": round(wall, 1),
            "ess_min": round(s["ess_min"], 1),
            "ess_per_sec_min": round(s["ess_per_sec_min"], 2),
            "rhat_max": round(s["rhat_max"], 4),
            "theta_mean": np.round(theta, 4).tolist(),
            "divergence_rate": round(
                float(res["kernel_results"]["divergences"].mean()), 5),
            "step_size": float(res["kernel_results"]["step_size"]),
        }
        out[f"{mass}_L{L}"] = cell
        print(json.dumps({f"{mass}_L{L}": cell}), flush=True)

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "..", "results", "seir_dense_mass_probe.json")
    if os.path.exists(path):  # merge so argv re-runs keep earlier cells
        with open(path) as fh:
            merged = json.load(fh)
        merged.update(out)
        out = merged
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
