"""Adjudicate the Hes1 unobserved-H coverage failure: mixing or marginal?

results/hes1_long2.json records H 95%-band coverage 0.256 vs truth while
theta diagnostics look converged (rhat 1.028, ESS_min 639), and
DEVIATIONS.md #23 (results/hes1_long.json) shows the Laplace band at
the truth-basin mode covers the true H everywhere — i.e. the local
curvature says the H marginal is WIDE, the sampled band is NARROW. Two
hypotheses the summary stats cannot distinguish:

  (a) sampler underdispersion: the centered parametrization mixes the
      unobserved component slowly (no data term on H — classic
      weak-likelihood centered-vs-noncentered failure), so the sampled
      band underestimates the posterior width. Signature: tiny per-grid-
      point H ESS and/or large per-point split R-hat.
  (b) converged-but-offset marginal: the H posterior really is narrow but
      sits on a different (g, f, H) combination along the measured flat
      directions (profile flat to 0.88 nats over f in [2.7, 80],
      results/hes1_profile.json). Signature: healthy H ESS/R-hat, and the
      sampled band hugging the ODE trajectory integrated at the SAMPLED
      thetas (self-consistency) while missing the truth.

This probe measures exactly those signatures on a shorter run: per-grid-
point H ESS and split R-hat (min / 5% / median over the grid), coverage
vs truth, and coverage vs the self-consistent ODE trajectory at the
posterior-mean theta and initial state.

Reference context: the reference cannot run Hes1 at all (its sampler
crashes at HEAD, SURVEY.md section 4); the recipe here is the measured
one from examples/hes1.py (centered, beta=1, sigma fixed).

Writes results/hes1_H_mixing_probe.json.
"""

import argparse
import json
import os
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--burnin", type=int, default=1500)
    ap.add_argument("--results", type=int, default=3000)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/hes1_H_mixing_probe.json")
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
    from magi_v2_tpu.utils.data import simulate_ode
    from magi_v2_tpu.utils.diagnostics import (
        effective_sample_size,
        potential_scale_reduction,
    )

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
    model.beta = 1.0  # original-MAGI weighting (see examples/hes1.py)

    t0 = time.time()
    res = model.predict(
        num_results=args.results, num_burnin_steps=args.burnin,
        num_chains=args.chains, init_jitter=0.02, verbose=True,
        seed=args.seed, reparam="centered", use_annealing=False,
        sigma_sqs_fixed=0.15 ** 2,
    )
    wall = time.time() - t0

    NI = model.mag_I
    th = np.asarray(res["thetas_samps"])             # (T, C, 7)
    X = np.asarray(res["X_samps"])                   # (T, C, N_I, 3)

    # truth-basin filter (same classifier as hes1_long.py: decoupled mode
    # collapses g ~ 3 vs truth 20)
    g_per_chain = th[..., 5].mean(axis=0)
    in_basin = g_per_chain > 8.0
    n_in = int(in_basin.sum())
    th_b = th[:, in_basin]
    X_b = X[:, in_basin]

    # ---- per-grid-point H mixing diagnostics --------------------------
    H = X_b[..., 2]                                  # (T, C_in, N_I)
    ess_H = np.array([effective_sample_size(H[:, :, i])
                      for i in range(NI)])
    rhat_H = np.array([potential_scale_reduction(H[:, :, i])
                       for i in range(NI)])

    # ---- coverage vs truth and vs the self-consistent trajectory ------
    logH_true = np.interp(
        np.linspace(0, 240, NI), np.linspace(0, 240, len(X_true)),
        np.log(X_true[:, 2]),
    )
    Hf = H.reshape(-1, NI)
    lo, hi = np.quantile(Hf, [0.025, 0.975], axis=0)
    cov_truth = float(((logH_true >= lo) & (logH_true <= hi)).mean())

    # self-consistency yardstick: integrate the Hes1 ODE at the posterior-
    # mean theta from the posterior-mean initial state; if the band covers
    # THIS trajectory, the H marginal is internally consistent and the
    # truth miss is the flat-direction offset, not underdispersion
    th_mean = th_b.mean(axis=(0, 1))
    x0_mean = np.exp(X_b.mean(axis=(0, 1))[0])       # natural scale
    _, _, X_self = simulate_ode(
        MODEL_REGISTRY["hes1"].f_vec,
        x0=x0_mean, thetas=th_mean, t_max=240.0, n_obs=NI,
        noise_sd=0.0, substeps=200,
    )
    logH_self = np.log(np.maximum(X_self[:, 2], 1e-12))
    cov_self = float(((logH_self >= lo) & (logH_self <= hi)).mean())

    # per-point z of truth against the sampled marginal
    mu_H, sd_H = Hf.mean(axis=0), Hf.std(axis=0)
    z_truth = (logH_true - mu_H) / np.maximum(sd_H, 1e-12)

    out = {
        "config": (
            f"Hes1 log-scale, H unobserved, {args.chains} x "
            f"{args.burnin}+{args.results} NUTS, centered, beta=1, sigma "
            f"fixed 0.15^2, {'f64' if args.f64 else 'f32'} "
            f"{'cpu' if args.cpu else 'default'}"
        ),
        "chains_in_truth_basin": f"{n_in}/{args.chains}",
        "theta_ratio_to_truth": [round(v, 3)
                                 for v in (th_b.mean(axis=(0, 1)) / true)],
        "H_ess_min": round(float(ess_H.min()), 1),
        "H_ess_p05": round(float(np.quantile(ess_H, 0.05)), 1),
        "H_ess_median": round(float(np.median(ess_H)), 1),
        "H_rhat_max": round(float(rhat_H.max()), 4),
        "H_rhat_p95": round(float(np.quantile(rhat_H, 0.95)), 4),
        "H_rhat_median": round(float(np.median(rhat_H)), 4),
        "H_coverage_95_vs_truth": round(cov_truth, 3),
        "H_coverage_95_vs_self_consistent_ode": round(cov_self, 3),
        "z_truth_abs_max": round(float(np.abs(z_truth).max()), 2),
        "z_truth_abs_median": round(float(np.median(np.abs(z_truth))), 2),
        "mean_band_width": round(float((hi - lo).mean()), 4),
        "sampling_wall_s": round(wall, 1),
        "setup_s": round(setup_s, 1),
        "device": str(jax.devices()[0].platform),
    }
    os.makedirs("results", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
