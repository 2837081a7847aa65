"""Hes1 parallel-tempering adjudication (VERDICT r4 Weak #5).

The Hes1 unobserved-H posterior is multimodal: a truth-coupled basin and
a HIGHER-density decoupled-H mode (independently transliteration-
validated, DEVIATIONS #23). Round 4 shipped a workaround — centered
sampling + Laplace-dispersed starts that stay in the start basin — but no
sampler-side treatment. This script runs the sampler-side treatment:
``predict(pt_betas=...)`` replica exchange (sampler/run.py), the
beta=1 rung's draws then carry whatever mode visits the hot rungs ferry
down, so the MEASURED mode split (not the init choice) decides the
answer.

What it records (results/hes1_pt.json):
- per-adjacent-pair swap acceptance (ladder health),
- the beta=1 mode split (per-chain AND per-draw g-classifier — a chain
  that hops mid-run is the success signature),
- mode-conditional theta means vs truth and vs the round-4 recipe,
- unobserved-H 95% band coverage of truth, pooled and per mode.

Recipe mirrors scripts/hes1_long.py (centered, beta=1, sigma fixed at
the generating 0.15^2, resolution-gated phi2 prior); only the chains
axis changes: R rungs x M replicas, warmup shared at beta=1.
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
    ap.add_argument("--replicas", type=int, default=16,
                    help="chains per rung (M); total chains = M * len(betas)")
    ap.add_argument("--betas", default="1.0,0.6,0.36,0.22,0.13",
                    help="comma-separated PT ladder, must start at 1.0")
    ap.add_argument("--swap-every", type=int, default=1)
    ap.add_argument("--burnin", type=int, default=3000)
    ap.add_argument("--results", type=int, default=8000)
    ap.add_argument("--init", default="heuristic",
                    choices=["heuristic", "laplace"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--out", default="results/hes1_pt.json")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    from magi_v2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu.models import MODEL_REGISTRY, hes1_log_f_vec
    from magi_v2_tpu.utils import summarize_chains
    from magi_v2_tpu.utils.data import simulate_ode

    betas = tuple(float(b) for b in args.betas.split(","))
    R, M = len(betas), args.replicas
    C = R * M

    true = np.array(MODEL_REGISTRY["hes1"].true_thetas)
    ts_obs, _, X_true = simulate_ode(
        MODEL_REGISTRY["hes1"].f_vec,
        x0=np.array([1.439, 2.037, 17.904]),
        thetas=true, t_max=240.0, n_obs=33, noise_sd=0.0, substeps=200,
    )
    rng = np.random.default_rng(0)
    X_obs_log = np.log(X_true) + 0.15 * rng.standard_normal(X_true.shape)
    X_obs_log[:, 2] = np.nan  # H fully unobserved

    cfg = MagiConfig()
    if not args.f64:
        cfg = cfg.replace(dtype=jnp.float32)
    model = MAGI_v2(
        D_thetas=7, ts_obs=ts_obs, X_obs=X_obs_log, bandsize=None,
        f_vec=hes1_log_f_vec, config=cfg,
    )
    t0 = time.time()
    model.initial_fit(discretization=2, verbose=True)
    setup_s = time.time() - t0
    print(f"initial_fit: {setup_s:.1f}s theta_init={model.thetas_init}",
          flush=True)
    model.beta = 1.0  # original-MAGI weighting (see examples/hes1.py)

    init_states = None
    if args.init == "laplace":
        r_map = model.map_estimate(
            sigma_sqs_fixed=0.15 ** 2, laplace_draws=C,
            draws_seed=args.seed + 101, verbose=True,
        )
        init_states = {"X": r_map["X_draws"],
                       "thetas": r_map["theta_draws"]}

    t0 = time.time()
    res = model.predict(
        num_results=args.results, num_burnin_steps=args.burnin,
        num_chains=C, init_jitter=0.02, verbose=True, seed=args.seed,
        reparam="centered", use_annealing=False,
        sigma_sqs_fixed=0.15 ** 2, init_states=init_states,
        pt_betas=betas, pt_swap_every=args.swap_every,
    )
    wall = time.time() - t0

    th = np.asarray(res["thetas_samps"])            # (T, M, 7) — beta=1 rung
    swap_acc = res["kernel_results"]["pt_swap_accept"]
    summary = summarize_chains(th, wall)

    # mode classification: decoupled mode collapses g (theta_6) to ~3 vs
    # truth 20 (hes1_long.py) — classify per DRAW so mid-run hops count
    g_draws = th[..., 5]                            # (T, M)
    in_basin_draw = g_draws > 8.0
    frac_coupled = float(in_basin_draw.mean())
    g_chain = g_draws.mean(axis=0)
    chains_hopped = int(
        ((in_basin_draw.mean(axis=0) > 0.02)
         & (in_basin_draw.mean(axis=0) < 0.98)).sum()
    )

    def mode_stats(mask):
        if mask.sum() == 0:
            return None
        sel = th[mask]                              # (n, 7)
        return {
            "n_draws": int(mask.sum()),
            "theta_mean": np.round(sel.mean(0), 4).tolist(),
            "theta_over_truth": np.round(sel.mean(0) / true, 3).tolist(),
        }

    NI = model.mag_I
    logH_true = np.interp(np.linspace(0, 240, NI),
                          np.linspace(0, 240, len(X_true)),
                          np.log(X_true[:, 2]))
    H = np.asarray(res["X_samps"])[..., 2].reshape(-1, NI)
    lo, hi = np.quantile(H, [0.025, 0.975], axis=0)
    cov_pooled = float(((logH_true >= lo) & (logH_true <= hi)).mean())
    mflat = in_basin_draw.reshape(-1)
    cov_coupled = None
    if 0 < mflat.sum() < len(mflat):
        lo_c, hi_c = np.quantile(H[mflat], [0.025, 0.975], axis=0)
        cov_coupled = float(((logH_true >= lo_c)
                             & (logH_true <= hi_c)).mean())

    out = {
        "config": (f"Hes1 log-scale H-unobserved, PT ladder {betas}, "
                   f"{M} replicas/rung ({C} chains), "
                   f"{args.burnin}+{args.results}, swap_every="
                   f"{args.swap_every}, centered beta=1 sigma-fixed, "
                   f"init={args.init}, "
                   f"{'f64' if args.f64 else 'f32'}"),
        "pt_swap_accept": np.round(np.asarray(swap_acc), 4).tolist(),
        "frac_draws_coupled_mode": round(frac_coupled, 4),
        "chains_hopped_mid_run": chains_hopped,
        "per_chain_mean_g": np.round(g_chain, 2).tolist(),
        "coupled_mode": mode_stats(in_basin_draw.reshape(-1)),
        "decoupled_mode": mode_stats(~in_basin_draw.reshape(-1)),
        "H_coverage_95_pooled": cov_pooled,
        "H_coverage_95_coupled_only": cov_coupled,
        "ess_min_beta1": round(summary["ess_min"], 1),
        "rhat_max_beta1_pooled": round(summary["rhat_max"], 4),
        "note_rhat": ("pooled R-hat over a mode-split ensemble is a mode-"
                      "split detector, not a convergence failure — "
                      "mode-conditional stats above carry the inference"),
        "theta_true": true.tolist(),
        "sampling_wall_s": round(wall, 1),
        "setup_s": round(setup_s, 1),
        "device": str(jax.devices()[0].device_kind),
    }
    os.makedirs("results", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    np.savez_compressed(args.out.replace(".json", "_theta.npz"),
                        thetas=th.astype(np.float32))
    print(json.dumps(out, indent=1), flush=True)


if __name__ == "__main__":
    main()
