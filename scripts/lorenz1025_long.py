"""Long Lorenz N_I=1025 acceptance run (BASELINE.json configs[4]).

Converged recipe (run r3j, results/lorenz1025_r3j.json — rhat_max 1.0498,
ESS_min 4994, eps 0.144, zero divergences):

    --refresh 0 --anneal-mode reference --min-temp 0.15 --sigma-fixed 0.25

i.e. init-anchored banded Gauss-Newton whitening, NO mid-warmup refresh
(measured harmful: DEVIATIONS.md #22), the
reference's log anneal schedule pinned at a 0.15 temperature floor before
sampling starts (a FIXED tempered target, so rhat/ESS are valid), and the
observation noise pinned (a free sigma^2 inflates under tempering until
the data decouple).

The beta=1 target itself is eps-collapsed at this grid density for ANY
fixed metric (DEVIATIONS.md #22); the
tempered target carries a floor-INDEPENDENT theta bias of ~(-8..-11%,
-1..-3%, -11%) vs (10, 28, 8/3) (floor sweep 0.15/0.3/0.5,
results/lorenz1025_floor_*.json). ROUND-4 ADJUDICATION (DEVIATIONS.md
#25-#26, results/lorenz_joint_map_probe.json): the bias is the BANDSIZE TRUNCATION of the
precision operators, NOT a property of the MAGI posterior — the exact
(dense-operator) beta=1 joint MAP recovers theta to (+0.6, -0.1, +0.1)%,
while the b=100 truncated posterior's own mode carries (-15.6, -6.6,
-10.6)% (matching this run's sampled offset) and no affordable bandsize
fixes it (63% of K^-1's Frobenius mass is off-band at b=100, 49% at
b=300; the b=200 mode overshoots theta_0 +23%). So this recipe samples a
band-truncated APPROXIMATION of the posterior; for an accurate beta=1
dense-grid answer use MAGI_v2.map_estimate() (exact operators, Laplace
CIs). At N_I=513 (K^-1 truncation 0.8%) sampled recovery is essentially
exact (results/calibration_table.json: theta within 0.06%, trajectory
coverage 1.0).

Writes a JSON summary + theta draws to results/.
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
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--burnin", type=int, default=2000)
    ap.add_argument("--results", type=int, default=1000)
    ap.add_argument("--thin", type=int, default=2)
    ap.add_argument("--leapfrogs", type=int, default=64)
    ap.add_argument("--refresh", type=int, default=500)
    ap.add_argument("--restart", default="laplace",
                    choices=["laplace", "remap"])
    ap.add_argument("--scatter", type=float, default=0.1)
    ap.add_argument("--anneal-mode", default="warmup_only",
                    choices=["warmup_only", "reference"],
                    help="'reference' keeps the log-temperature schedule "
                         "through sampling (the reference's own regime; "
                         "the beta=1 target at N_I=1025 is eps-collapsed "
                         "for any fixed metric — measured b-sweep: frozen "
                         "eps 3.9e-4 at b=100, 7.1e-6 at b=200)")
    ap.add_argument("--min-temp", type=float, default=0.1,
                    help="anneal floor; with --anneal-mode reference, a "
                         "floor the schedule reaches BEFORE sampling pins "
                         "a FIXED tempered target (valid rhat/ESS)")
    ap.add_argument("--untempered", action="store_true",
                    help="use_annealing=False: adapt AND sample at beta=1. "
                         "The theta init is already in-basin for Lorenz; "
                         "tempered warmup drags theta_3 low and adapts eps "
                         "to the flattened posterior (measured: refresh runs "
                         "diverged at 89-99% from the first stage-B draw)")
    ap.add_argument("--sigma-fixed", type=float, default=0.0,
                    help="pin the observation-noise variances at this KNOWN "
                         "value (0 = sample sigma). Required for a tempered "
                         "run to stay identified: with sigma free the "
                         "flattened posterior inflates sigma^2 until the "
                         "data decouple and theta collapses (measured: SEIR "
                         "5000+5000 DEVIATIONS #16; Lorenz N_I=1025 floor "
                         "0.15, run r3j — theta mean fell to (2.5, 24.8, "
                         "0.64) as chains actually mixed)")
    ap.add_argument("--mass", default="diag",
                    choices=["diag", "tail_dense"],
                    help="'tail_dense' adds a dense inverse-mass block over "
                         "theta_pre (sigma is pinned in the acceptance "
                         "recipe), rotating theta-theta ridges a diagonal "
                         "metric cannot")
    ap.add_argument("--bandsize", type=int, default=100,
                    help="precision-operator half-bandwidth. The round-4 "
                         "joint-MAP adjudication (results/"
                         "lorenz_joint_map_probe.json) localized the "
                         "tempered recipe's theta offset to b=100 operator "
                         "truncation (dense beta=1 MAP is at truth); wider "
                         "bands should shrink it at O(N*b) cost")
    ap.add_argument("--storage", default="banded",
                    choices=["banded", "hybrid"],
                    help="'hybrid' keeps the banded GN whitening but "
                         "evaluates the posterior through the EXACT dense "
                         "operators (no target truncation) — the round-4 "
                         "mode that removes the b=100 truncation bias at "
                         "O(D*N_I^2) per-leapfrog cost")
    ap.add_argument("--n-obs", type=int, default=257)
    ap.add_argument("--disc", type=int, default=2,
                    help="discretization doubling knob: N_I = "
                         "2^disc*(n_obs-1)+1. disc=3 with 257 obs gives the "
                         "N_I=2049 max-scale grid (halved h: 16x stiffer "
                         "h^-4 manifold, finer-h truncation regime)")
    ap.add_argument("--map-anchor", action="store_true",
                    help="anchor the GN whitening factor AND the relative-"
                         "energy zero point at the f64 MAP "
                         "(map_estimate, exact operators) instead of the "
                         "spline init, and start chains there. The round-5 "
                         "fix for the N_I=2049 eps collapse: beyond the "
                         "init anchor's neighborhood the f32 surface at "
                         "h^-4 ~1e12 operator scale is evaluation noise "
                         "(results/stiffness_probe.json); the MAP anchor's "
                         "residual magnitudes are ~1e3x smaller and chains "
                         "stay in the resolvable neighborhood. The MAP is "
                         "cached in results/ keyed on (N_I, bandsize, "
                         "sigma) so retries skip the CPU solve")
    ap.add_argument("--anchor-scatter", type=float, default=0.1,
                    help="with --map-anchor: per-coordinate chain scatter "
                         "around the whitened anchor (init_jitter acts in "
                         "the GN-whitened coordinates, so this is a scaled "
                         "GN-Laplace dispersal)")
    ap.add_argument("--map-warmstart", type=int, default=0,
                    help="Adam steps of beta=1 MAP polish in the sampler's "
                         "whitened coordinates before chains launch "
                         "(predict(map_warmstart_iters=...)). The N_I=2049 "
                         "failure mode: the heuristic init is far enough "
                         "off-manifold that the f32 posterior surface at "
                         "the init is numerically unresolvable (measured "
                         "lp(q0) ~ +1.7e9 garbage at disc=3) and chains "
                         "freeze; the polish walks back onto the manifold "
                         "first")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--checkpoint", default="",
                    help="sampler checkpoint dir (crash recovery; resume "
                         "by re-running with identical args)")
    ap.add_argument("--out", default="results/lorenz1025_r3.json")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from magi_v2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu.models import lorenz_f_vec
    from magi_v2_tpu.utils import summarize_chains
    from magi_v2_tpu.utils.data import simulate_ode

    true = np.array([10.0, 28.0, 8.0 / 3.0])
    ts_obs, X_obs, X_true = simulate_ode(
        lorenz_f_vec,
        x0=np.array([-8.0, 7.0, 27.0]),
        thetas=true,
        t_max=2.0,
        n_obs=args.n_obs,
        noise_sd=0.5,
        substeps=50,
    )

    cfg = MagiConfig().replace(dtype=jnp.float32,
                               anneal_min_temp=args.min_temp)
    model = MAGI_v2(
        D_thetas=3, ts_obs=ts_obs, X_obs=X_obs, bandsize=args.bandsize,
        f_vec=lorenz_f_vec, config=cfg,
    )
    t0 = time.time()
    model.initial_fit(discretization=args.disc, verbose=True)
    setup_s = time.time() - t0
    print(f"initial_fit: {setup_s:.1f}s  N_I={model.mag_I}  "
          f"theta_init={model.thetas_init}", flush=True)

    gn_anchor = None
    init_states = None
    init_jitter = 0.05
    map_wall_s = 0.0
    if args.map_anchor:
        from magi_v2_tpu.map_laplace import map_estimate

        cache = (f"results/lorenz_map_cache_N{model.mag_I}"
                 f"_b{args.bandsize}_s{args.sigma_fixed:g}.npz")
        if os.path.exists(cache):
            with np.load(cache) as z:
                X_map, theta_map = z["X_map"], z["theta_map"]
            print(f"map anchor: loaded {cache}", flush=True)
        else:
            t0 = time.time()
            mp = map_estimate(
                model,
                sigma_sqs_fixed=(args.sigma_fixed or None),
                laplace=False, verbose=True,
            )
            map_wall_s = time.time() - t0
            if not mp["converged"]:
                print(f"WARNING: MAP not converged "
                      f"(|g|={mp['grad_norm']:.3g})", flush=True)
            X_map, theta_map = mp["X_map"], mp["theta_map"]
            os.makedirs("results", exist_ok=True)
            np.savez_compressed(cache, X_map=X_map, theta_map=theta_map)
            print(f"map anchor: theta_map={np.round(theta_map, 4)} "
                  f"in {map_wall_s:.0f}s -> {cache}", flush=True)
        gn_anchor = {"X": X_map, "thetas": theta_map}
        init_states = {"thetas": theta_map}
        init_jitter = args.anchor_scatter

    t0 = time.time()
    res = model.predict(
        num_results=args.results,
        num_burnin_steps=args.burnin,
        num_chains=args.chains,
        verbose=True,
        seed=args.seed,
        map_warmstart_iters=args.map_warmstart,
        init_jitter=init_jitter,
        gn_anchor=gn_anchor,
        init_states=init_states,
        storage=args.storage,
        reparam="precond",
        algorithm="hmc",
        hmc_num_leapfrogs=args.leapfrogs,
        thin=args.thin,
        precond_refresh_steps=args.refresh,
        precond_refresh_restart=args.restart,
        precond_refresh_scatter=args.scatter,
        checkpoint_path=args.checkpoint,
        use_annealing=not args.untempered,
        anneal_mode=args.anneal_mode,
        sigma_sqs_fixed=(args.sigma_fixed or None),
        mass_matrix=args.mass,
    )
    wall = time.time() - t0

    theta = res["thetas_samps"]            # (T, C, 3)
    diag = summarize_chains(theta, wall)
    theta_mean = theta.mean(axis=(0, 1))
    ks = res["kernel_results"]

    # trajectory recovery vs the noiseless truth at observation times
    X = res["X_samps"]                     # (T, C, N_I, D)
    obs_rows = np.searchsorted(model.I[:, 0], ts_obs)
    Xo = X[:, :, obs_rows, :].reshape(-1, len(ts_obs), X.shape[-1])
    lo, hi = np.percentile(Xo, [2.5, 97.5], axis=0)
    coverage = float(((X_true >= lo) & (X_true <= hi)).mean())
    rmse = float(np.sqrt(((Xo.mean(axis=0) - X_true) ** 2).mean()))

    summary = {
        "config": (
            f"Lorenz N_I={model.mag_I}, {args.chains} chains, "
            f"{args.burnin}+{args.results}x{args.thin} HMC-L{args.leapfrogs}, "
            f"{args.storage} GN (b={args.bandsize}), "
            f"anchor={'map scatter=%g' % args.anchor_scatter if args.map_anchor else 'init'}, "
            f"warmstart={args.map_warmstart}, refresh={args.refresh} "
            f"restart={args.restart} scatter={args.scatter}, "
            f"{'untempered' if args.untempered else args.anneal_mode}"
            f"(floor={args.min_temp}), "
            f"sigma={'fixed %g' % args.sigma_fixed if args.sigma_fixed else 'free'}, "
            f"mass={args.mass}, f32"
        ),
        "theta_mean": [round(float(v), 4) for v in theta_mean],
        "theta_sd": [
            round(float(v), 4) for v in theta.reshape(-1, 3).std(axis=0)
        ],
        "theta_true": list(true),
        "theta_rel_err": [
            round(float(v), 4) for v in (theta_mean - true) / true
        ],
        "ess_min": round(diag["ess_min"], 1),
        "ess_mean": round(diag["ess_mean"], 1),
        "rhat_max": round(diag["rhat_max"], 4),
        "eps": round(float(ks["step_size"]), 5),
        "accept": round(float(np.mean(ks["accept_probs"])), 4),
        "div_rate": round(float(np.mean(ks["divergences"])), 6),
        "traj_coverage_95": round(coverage, 4),
        "traj_rmse": round(rmse, 4),
        "sampling_wall_s": round(wall, 1),
        "setup_s": round(setup_s, 1),
        "map_anchor_wall_s": round(map_wall_s, 1),
        "device": str(jax.devices()[0].device_kind),
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    np.savez_compressed(
        args.out.replace(".json", "_theta.npz"),
        thetas=theta.astype(np.float32),
        accept=ks["accept_probs"].astype(np.float32),
    )
    print(json.dumps(summary, indent=1), flush=True)


if __name__ == "__main__":
    main()
