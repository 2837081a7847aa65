"""Statistically-solid Hes1 run (VERDICT round-2 item 3).

The round-2 recorded recovery (CPU f64, 4x600+600) had ESS_min 10 and
R-hat 1.28. This script runs the same measured recipe (resolution-gated
phi2 prior, beta=1, sigma_sqs_fixed, centered + no annealing — see
examples/hes1.py for why) at many chains x long, targeting
rhat_max <= 1.05 and ESS_min >= 100, and adds an INDEPENDENT check of the
multimodality claim: the library's own lp AND a NumPy/SciPy transliterated
posterior (independent operators: SciPy Bessel + finite differences +
np.linalg.pinv — no code shared with magi_v2_tpu.ops) are both evaluated
at the truth-basin posterior mean and at the decoupled-H degenerate state;
the claim stands only if the two independent stacks agree on the ordering.

Writes results/hes1_long.json.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
from r_offset_validation import scipy_operators, transliterated_lp  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--burnin", type=int, default=2000)
    ap.add_argument("--results", type=int, default=2000)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init", default="heuristic",
                    choices=["heuristic", "laplace"],
                    help="'laplace' starts every chain from a JOINT draw "
                         "of the Laplace approximation at the truth-basin "
                         "MAP (map_estimate(laplace_draws=chains) -> "
                         "predict(init_states=...)) — correctly dispersed "
                         "starts for the slowly-mixing unobserved-H block "
                         "(the sampled 0.256 H coverage is measured "
                         "underdispersion, DEVIATIONS.md #23 "
                         "'hes1_H_calibration')")
    ap.add_argument("--init-scale", type=float, default=1.0,
                    help="Laplace draw scale (draws_scale); <1 shrinks the "
                         "scatter toward the MAP")
    ap.add_argument("--checkpoint", default="",
                    help="sampler checkpoint dir (crash recovery)")
    ap.add_argument("--out", default="results/hes1_long.json")
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

    true = np.array(MODEL_REGISTRY["hes1"].true_thetas)
    ts_obs, _, X_true = simulate_ode(
        MODEL_REGISTRY["hes1"].f_vec,
        x0=np.array([1.439, 2.037, 17.904]),
        thetas=true,
        t_max=240.0,
        n_obs=33,
        noise_sd=0.0,
        substeps=200,
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
    print(f"initial_fit: {setup_s:.1f}s  theta_init={model.thetas_init}",
          flush=True)
    model.beta = 1.0  # original-MAGI weighting (see examples/hes1.py)

    init_states, map_wall_s = None, 0.0
    if args.init == "laplace":
        t0 = time.time()
        r_map = model.map_estimate(
            sigma_sqs_fixed=0.15 ** 2, laplace_draws=args.chains,
            draws_seed=args.seed + 101, draws_scale=args.init_scale,
            verbose=True,
        )
        map_wall_s = time.time() - t0
        print(f"[laplace-init] MAP wall {map_wall_s:.1f}s, converged="
              f"{r_map['converged']}, theta_map/truth="
              f"{np.round(r_map['theta_map'] / true, 3)}, draw-g range "
              f"[{r_map['theta_draws'][:, 5].min():.2f}, "
              f"{r_map['theta_draws'][:, 5].max():.2f}]", flush=True)
        init_states = {"X": r_map["X_draws"],
                       "thetas": r_map["theta_draws"]}

    t0 = time.time()
    res = model.predict(
        num_results=args.results, num_burnin_steps=args.burnin,
        num_chains=args.chains, init_jitter=0.02, verbose=True,
        seed=args.seed, reparam="centered", use_annealing=False,
        sigma_sqs_fixed=0.15 ** 2, checkpoint_path=args.checkpoint,
        init_states=init_states,
    )
    wall = time.time() - t0

    th = np.asarray(res["thetas_samps"])            # (T, C, 7)
    summary = summarize_chains(th, wall)
    mean = th.mean(axis=(0, 1))

    # ---- per-chain mode classification -------------------------------
    # The Hes1 posterior is multimodal (decoupled-H mode, see below); a
    # pooled R-hat over a mode-split ensemble certifies nothing.
    # Classify each chain by its posterior-mean theta_6 (g, the Hill
    # production rate): the decoupled mode collapses g (escaped run shows
    # g ~ 3 vs truth 20), so a per-chain mean g < 8 marks an escaped
    # chain. Report within-truth-basin diagnostics alongside the pooled.
    g_per_chain = th[..., 5].mean(axis=0)                     # (C,)
    in_basin = g_per_chain > 8.0
    n_in = int(in_basin.sum())
    if 0 < n_in < th.shape[1]:
        basin_summary = summarize_chains(th[:, in_basin], wall)
    else:
        basin_summary = summary
    basin_mean = th[:, in_basin].mean(axis=(0, 1)) if n_in else mean
    NI = model.mag_I
    logH_true = np.interp(
        np.linspace(0, 240, NI), np.linspace(0, 240, len(X_true)),
        np.log(X_true[:, 2]),
    )
    H_tc = np.asarray(res["X_samps"])[..., 2]      # (T, C, N_I)
    H = H_tc.reshape(-1, NI)
    lo, hi = np.quantile(H, [0.025, 0.975], axis=0)
    cov = float(((logH_true >= lo) & (logH_true <= hi)).mean())

    # ---- H mixing + self-consistency yardsticks ------------------------
    # (same diagnostics as scripts/hes1_H_mixing_probe.py, recorded on the
    # acceptance run itself)
    # per-grid-point ESS / split R-hat over the unobserved component: theta
    # ESS does not certify the 129-dim H block
    from magi_v2_tpu.utils.diagnostics import (
        effective_sample_size,
        potential_scale_reduction,
    )

    ess_H = np.array([effective_sample_size(H_tc[:, :, i])
                      for i in range(NI)])
    rhat_H = np.array([potential_scale_reduction(H_tc[:, :, i])
                       for i in range(NI)])
    # self-consistency: if the band covers the ODE trajectory integrated at
    # the SAMPLED posterior-mean (theta, x0), the H marginal is internally
    # consistent and any truth miss is the measured flat-direction theta
    # offset propagated through the ODE manifold, not band width.
    # The posterior is multimodal (that is why in_basin exists), so the
    # integration point must be the TRUTH-BASIN mean: a cross-mode pooled
    # average corresponds to no mode and would make cov_self meaningless
    # whenever any chain escapes.
    X_samps_all = np.asarray(res["X_samps"])                 # (T, C, N_I, 3)
    X_basin = X_samps_all[:, in_basin] if 0 < n_in else X_samps_all
    x0_mean = np.exp(X_basin.mean(axis=(0, 1))[0])
    _, _, X_self = simulate_ode(
        MODEL_REGISTRY["hes1"].f_vec,
        x0=x0_mean, thetas=basin_mean, t_max=240.0, n_obs=NI,
        noise_sd=0.0, substeps=200,
    )
    logH_self = np.log(np.maximum(X_self[:, 2], 1e-12))
    cov_self = float(((logH_self >= lo) & (logH_self <= hi)).mean())

    # ---- independent multimodality check -----------------------------
    # State A: the truth-basin posterior mean from this run (basin-restricted
    # for the same multimodality reason as cov_self above).
    # State B: the decoupled-H mode, found the way it was originally
    # observed (examples/hes1.py docstring): a short GN-whitened
    # (reparam='precond') run escapes the truth basin from the same init;
    # its highest-lp draw is the representative of the escaped mode.
    X_mean = X_basin.mean(axis=(0, 1))                      # (N_I, 3)
    softminus = lambda y: np.log(np.expm1(np.maximum(y, 1e-8)))

    def flat_state(X, sig_sq, th7):
        sig_pre = softminus(np.maximum(sig_sq - sigma_LB, 1e-8))
        th_pre = softminus(th7)
        return (np.asarray(X, np.float64), np.asarray(sig_pre),
                np.asarray(th_pre))

    sigma_LB = (model.Xhat_init.std(axis=0)
                * model.config.sigma_sq_lb_scale) ** 2
    sig_fix = np.full(3, 0.15 ** 2)
    sigma_LB = np.minimum(sigma_LB, 0.5 * sig_fix)

    print("[multimodality] short GN-whitened escape run ...", flush=True)
    res_b = model.predict(
        num_results=200, num_burnin_steps=400, num_chains=4,
        init_jitter=0.02, seed=args.seed + 7, reparam="precond",
        use_annealing=False, sigma_sqs_fixed=0.15 ** 2, verbose=False,
    )
    X_b = np.asarray(res_b["X_samps"]).reshape(-1, NI, 3)
    th_b = np.asarray(res_b["thetas_samps"]).reshape(-1, 7)
    sub_idx = np.linspace(0, len(X_b) - 1, 200).astype(int)

    from magi_v2_tpu.posterior import make_posterior_data, make_log_posterior

    data = make_posterior_data(
        model.I, model.C_d_invs, model.m_ds, model.K_d_invs, model.mu_ds,
        model.beta, model.obs_index, sigma_LB, jnp.float64,
    )
    import contextlib

    # f64 scoring runs on the CPU backend in a scoped x64, so the f32
    # sampling process keeps x64 off globally
    stack = contextlib.ExitStack()
    stack.enter_context(jax.enable_x64(True))
    if jax.default_backend() != "cpu":
        stack.enter_context(jax.default_device(jax.devices("cpu")[0]))
    with stack:
        lp_ours = jax.jit(make_log_posterior(data, hes1_log_f_vec))
        obs = model.obs_index
        I_flat = model.I.reshape(-1)
        sci_C, sci_m, sci_K = [], [], []
        for d in range(3):
            C_inv, m, K_inv = scipy_operators(
                I_flat, model.phi1s[d], model.phi2s[d],
                model.BANDSIZE if model.BANDSIZE else len(I_flat),
            )
            sci_C.append(C_inv)
            sci_m.append(m)
            sci_K.append(K_inv)
        f_np = lambda Xv, tv: np.asarray(
            hes1_log_f_vec(jnp.asarray(model.I), jnp.asarray(Xv),
                           jnp.asarray(tv))
        )

        # best draw of the escape run under the untempered posterior
        lps_b = []
        for i in sub_idx:
            Xs, sp, tp = flat_state(X_b[i], sig_fix, np.maximum(th_b[i], 1e-8))
            lps_b.append(float(lp_ours(jnp.asarray(Xs), jnp.asarray(sp),
                                       jnp.asarray(tp), 1.0)))
        i_best = sub_idx[int(np.argmax(lps_b))]
        X_esc, th_esc = X_b[i_best], np.maximum(th_b[i_best], 1e-8)
        print(f"[multimodality] escape-run best lp {max(lps_b):.1f}, "
              f"theta {np.round(th_esc, 4)}", flush=True)

        modes = {}
        for name, X, th7 in [("truth_basin", X_mean, basin_mean),
                             ("escaped_mode", X_esc, th_esc)]:
            Xs, sp, tp = flat_state(X, sig_fix, th7)
            v_ours = float(lp_ours(jnp.asarray(Xs), jnp.asarray(sp),
                                   jnp.asarray(tp), 1.0))
            v_sci = transliterated_lp(
                Xs, sp, tp, 1.0, np.stack(sci_C), np.stack(sci_m),
                np.stack(sci_K), model.mu_ds, model.beta, obs.N_ds,
                obs.not_nan_idxs, obs.not_nan_cols, obs.y_observed,
                sigma_LB, f_np,
            )
            modes[name] = {"lp_library": round(v_ours, 1),
                           "lp_scipy_independent": round(float(v_sci), 1)}
    both_agree = (
        (modes["escaped_mode"]["lp_library"]
         > modes["truth_basin"]["lp_library"])
        == (modes["escaped_mode"]["lp_scipy_independent"]
            > modes["truth_basin"]["lp_scipy_independent"])
    )

    summary_out = {
        "config": (
            f"Hes1 log-scale, H unobserved, {args.chains} chains x "
            f"{args.burnin}+{args.results} NUTS, centered, beta=1, "
            f"sigma fixed 0.15^2, init={args.init}"
            + (f"(scale={args.init_scale})" if args.init == "laplace"
               else "")
            + f", {'f64' if args.f64 else 'f32'} "
            f"{'cpu' if args.cpu else 'device-default'}"
        ),
        "theta_mean": [round(float(v), 4) for v in mean],
        "theta_sd": [round(float(v), 4)
                     for v in th.reshape(-1, 7).std(axis=0)],
        "theta_true": [float(v) for v in true],
        "theta_ratio_to_truth": [round(float(m / t), 3)
                                 for m, t in zip(mean, true)],
        "ess_min": round(summary["ess_min"], 1),
        "rhat_max": round(summary["rhat_max"], 4),
        "chains_in_truth_basin": f"{n_in}/{th.shape[1]}",
        "per_chain_mean_g": [round(float(v), 2) for v in g_per_chain],
        "truth_basin_only": {
            "theta_mean": [round(float(v), 4) for v in basin_mean],
            "theta_ratio_to_truth": [
                round(float(m / t), 3) for m, t in zip(basin_mean, true)
            ],
            "ess_min": round(basin_summary["ess_min"], 1),
            "rhat_max": round(basin_summary["rhat_max"], 4),
        },
        "H_coverage_95": round(cov, 3),
        "H_coverage_95_vs_self_consistent_ode": round(cov_self, 3),
        "H_ess_min": round(float(ess_H.min()), 1),
        "H_ess_median": round(float(np.median(ess_H)), 1),
        "H_rhat_max": round(float(rhat_H.max()), 4),
        "H_rhat_median": round(float(np.median(rhat_H)), 4),
        "multimodality_check": {
            **modes,
            "escaped_theta": [round(float(v), 4) for v in th_esc],
            "independent_stacks_agree_on_ordering": bool(both_agree),
        },
        "sampling_wall_s": round(wall, 1),
        "setup_s": round(setup_s, 1),
        "map_wall_s": round(map_wall_s, 1),
        "device": str(jax.devices()[0].device_kind
                      if hasattr(jax.devices()[0], "device_kind")
                      else jax.devices()[0]),
    }
    os.makedirs("results", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary_out, f, indent=1)
    np.savez_compressed(
        args.out.replace(".json", "_theta.npz"),
        thetas=th.astype(np.float32),
    )
    print(json.dumps(summary_out, indent=1), flush=True)


if __name__ == "__main__":
    main()
