"""10-seed robustness sweep of the bench's tempered headline cell.

The tempered (anneal_mode='reference') dense-metric warmup at L=192 is
seed-fragile with the RAW covariance estimate (worst-seed ESS_min
1664-5033, results/seir_tempered_shrink_probe.json);
dense_shrinkage=0.2 rescued it — but the round-3 evidence was 3 seeds,
thin for a fragility-motivated knob (VERDICT r3 Weak #3 / task 4). This
sweep runs the exact bench headline cell (256 chains x 1000+1000 HMC
L=192, mass_matrix='dense', dense_shrinkage=0.2, reference anneal
schedule, magi_v2.py:348,833-835) on seeds 0..9 and records per-seed
ESS_min / rhat_max / divergence rate / ESS/s.

Acceptance: worst-seed rhat_max <= 1.05 across all 10 seeds.
Writes results/seir_seed_sweep.json (merging argv re-runs).
Usage: python scripts/seir_seed_sweep.py [first_seed last_seed] [--two-window]

--two-window runs the same cell under staged mass adaptation
(mass_window=(0.25, 0.45), mass_window2=(0.50, 0.72) — the round-5
candidate fix for the 5-7x worst-seed ESS tail: the second window
re-estimates the dense covariance from chains already mixing under the
first window's metric) and writes results/seir_seed_sweep_2win.json.
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

    two_win = "--two-window" in sys.argv
    win1_diag = "--win1-diag" in sys.argv
    pos = [a for a in sys.argv[1:] if not a.startswith("--")]
    lo, hi = (int(pos[0]), int(pos[1])) if len(pos) >= 2 else (0, 9)
    win_kw = (dict(mass_window=(0.25, 0.45), mass_window2=(0.50, 0.72),
                   mass_window1_diag=win1_diag)
              if two_win else {})

    ts_obs, X_obs, _ = load_seir_csv(t_max=4.0, d_obs=20)
    cfg = MagiConfig().replace(dtype=jnp.float32)
    model = MAGI_v2(D_thetas=3, ts_obs=ts_obs, X_obs=X_obs, bandsize=80,
                    f_vec=seir_f_vec, config=cfg)
    model.initial_fit(discretization=1)

    out = {}
    for seed in range(lo, hi + 1):
        t0 = time.time()
        res = model.predict(
            num_results=1000, num_burnin_steps=1000, num_chains=256,
            seed=seed, init_jitter=0.01, algorithm="hmc",
            hmc_num_leapfrogs=192, anneal_mode="reference",
            mass_matrix="dense", dense_shrinkage=0.2,
            **win_kw,
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
        out[f"seed{seed}"] = cell
        print(json.dumps({f"seed{seed}": cell}), flush=True)

    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "results",
        ("seir_seed_sweep_2win_diag1.json" if win1_diag
         else "seir_seed_sweep_2win.json") if two_win
        else "seir_seed_sweep.json")
    if os.path.exists(path):
        with open(path) as fh:
            merged = json.load(fh)
        merged.pop("summary", None)
        merged.update(out)
        out = merged

    seeds = [k for k in out if k.startswith("seed")]
    out["summary"] = {
        "config": ("tempered bench headline cell: 256x1000+1000 HMC L=192, "
                   "mass_matrix=dense, dense_shrinkage=0.2, "
                   "anneal_mode=reference, f32"
                   + (", two-window mass adaptation (0.25-0.45, 0.50-0.72)"
                      + (", window-1 diag-only" if win1_diag else "")
                      if two_win else "")),
        "n_seeds": len(seeds),
        "worst_ess_min": min(out[k]["ess_min"] for k in seeds),
        "worst_rhat_max": max(out[k]["rhat_max"] for k in seeds),
        "worst_div_rate": max(out[k]["divergence_rate"] for k in seeds),
        "ess_per_sec_band": [min(out[k]["ess_per_sec_min"] for k in seeds),
                             max(out[k]["ess_per_sec_min"] for k in seeds)],
        "all_converged": bool(all(out[k]["rhat_max"] <= 1.05 for k in seeds)),
    }
    print(json.dumps({"summary": out["summary"]}), flush=True)

    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
