"""Benchmark: ESS/sec on the SEIR posterior with 256 vmapped HMC chains.

Prints ONE JSON line: {"metric", "value", "unit", "card", "detail"}.
Needs an NVIDIA GPU (fails otherwise — no CPU fallback).

Metric definition (BASELINE.json north star): pooled effective samples per
second of SAMPLING wall-clock for the worst theta component, 256 chains on
one GPU, SEIR vignette geometry (N=81 obs, discretization=1 -> N_I=161,
full hyperparameter + theta initialization).

Methodology:

- A short compile-priming run executes first so the timed runs hit the
  compiled-executable cache.
- The timed wall covers predict() of the main run only (setup/priming
  excluded, reported separately in detail).
- The JSON self-certifies convergence: rhat_max is computed from split
  R-hat over the 256 chains and the "converged" flag gates at 1.05.
- Roofline shares divide by the card's published peaks (PEAKS, keyed by
  ``device_kind``); the card's power limit is printed beside them.
"""

import json
import time

import numpy as np

NUM_CHAINS = 256
NUM_BURNIN = 1000
NUM_RESULTS = 1000
# Operating points (measured on the previous accelerator,
# results/seir_dense_mass_probe.json and seir_tempered_shrink_probe.json;
# statistical quantities only): the full dense metric
# (mass_matrix="dense") whitens the X-theta ridge (|corr| up to 0.89,
# results/seir_corr_probe.json) that forced L=192 under the diagonal
# metric (ESS_min 829 at L64 -> 18038 at L192). Dense-metric L-sweep on
# the TRUE posterior (warmup_only, ESS_min): L=96 -> 826 (warmup collapses below L~128), L=128 -> 43460,
# L=160 -> 113116, L=192 -> 177366 (the ESS-per-leapfrog peak, rhat
# 1.0005, reproduced at 188126 on a second seed), L=256 -> 132246.
# The TEMPERED cell (the headline, reference anneal schedule) is
# seed-fragile above L=128 with the RAW covariance estimate: worst-seed
# ESS_min 1664 (rhat 1.046) at L=160 and 5033 (div 1.2%) at L=192 vs
# 27146 (div 0.16%) at L=128 — the annealed warmup's dense-covariance
# estimate degrades on some seeds at long L. dense_shrinkage=0.2
# (correlations pulled 20% toward the diagonal) rescues it: seeds 0-2
# at tempered L=192 measure ESS_min 81k-100k, rhat <= 1.0029, div 0.4%.
# The true-posterior cell
# needs no shrinkage (stable raw: ESS_min 177k/188k over two seeds).
HMC_LEAPFROGS = 192
TEMPERED_SHRINKAGE = 0.2
TRUE_POST_LEAPFROGS = 192
MASS_MATRIX = "dense"


# Published peaks by JAX device_kind (NVIDIA H100 SXM data sheet, dense
# rates without sparsity, at the full 700 W power limit). The sampler pins
# matmul_precision="highest", so its f32 matmuls run on the FP32 units
# outside the tensor cores: fp32_flops is the compute roofline.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 SXM data sheet",
    },
}


def peaks_for(device_kind: str) -> dict:
    """The PEAKS entry of a device; an unknown device is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add it "
            "to bench.PEAKS with its source"
        ) from None


def _roofline(model, dtype, micro_evals_per_sec, peaks):
    """FLOP/byte accounting of the fused log-posterior+grad eval.

    Lowers the exact batched eval the microbench times (256 vmapped
    chains, matmul 'highest') and reads XLA's post-optimization cost
    analysis: 'flops' counts logical HLO flops, 'bytes accessed' the
    device-memory traffic of the fused executable. Combined with the
    measured evals/s this gives achieved TFLOP/s, achieved GB/s, and the
    roofline bound (whichever of FP32 compute time / HBM time dominates
    at the eval's intensity) against the card's published peaks.
    """
    import jax
    import jax.numpy as jnp

    from magi_v2_tpu.sampler.magi_state import flatten_state

    mode, *_ = model._build_sampling_setup("precond", "dense", dtype)
    q0 = flatten_state(
        mode.X0,
        jnp.zeros((model.D,), dtype),
        jnp.zeros((model.D_thetas,), dtype),
    )
    q = jnp.broadcast_to(q0, (NUM_CHAINS, q0.shape[0]))
    one = jnp.asarray(1.0, dtype)
    f = jax.jit(lambda q: jax.vmap(lambda r: mode.logp_grad(r, one))(q))
    with jax.default_matmul_precision("highest"):
        ca = f.lower(q).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    flops_batch = float(ca["flops"])
    bytes_batch = float(ca["bytes accessed"])

    flops_per_eval = flops_batch / NUM_CHAINS
    bytes_per_eval = bytes_batch / NUM_CHAINS
    achieved_flops = micro_evals_per_sec * flops_per_eval
    achieved_bytes = micro_evals_per_sec * bytes_per_eval
    # roofline: time per eval if purely compute-bound vs purely HBM-bound
    t_flop = flops_per_eval / peaks["fp32_flops"]
    t_hbm = bytes_per_eval / peaks["hbm_bytes_per_s"]
    t_meas = 1.0 / micro_evals_per_sec
    if t_hbm >= t_flop:
        bound = "HBM-bandwidth"
        roofline_frac = t_hbm / t_meas
    else:
        bound = "FP32-compute"
        roofline_frac = t_flop / t_meas
    return {
        "flops_per_eval": round(flops_per_eval, 1),
        "bytes_per_eval": round(bytes_per_eval, 1),
        "arithmetic_intensity_flops_per_byte": round(
            flops_per_eval / bytes_per_eval, 2
        ) if bytes_per_eval else None,
        "achieved_tflops": round(achieved_flops / 1e12, 3),
        "achieved_hbm_gb_per_s": round(achieved_bytes / 1e9, 1),
        "pct_of_fp32_peak": round(
            100 * achieved_flops / peaks["fp32_flops"], 2
        ),
        "bound": bound,
        "pct_of_roofline": round(100 * roofline_frac, 1),
        "peaks": peaks,
        "note": (
            "bound = max(FP32 time, HBM time) at the eval's intensity; "
            "pct_of_roofline = that bound's share of the measured eval "
            "time (the remainder is inter-fusion traffic/launch overhead "
            "the analysis attributes to neither peak)."
        ),
    }


def _microbench_fused_eval(model, dtype, iters=2000, repeats=3):
    """Median fused log-posterior+grad evals/sec/chip over ``repeats``
    timed dispatches of ``iters`` chained vmapped evals (256 chains)."""
    import jax
    import jax.numpy as jnp

    from magi_v2_tpu.sampler.magi_state import flatten_state

    mode, *_ = model._build_sampling_setup("precond", "dense", dtype)
    logp_grad = mode.logp_grad
    q0 = flatten_state(
        mode.X0,
        jnp.zeros((model.D,), dtype),
        jnp.zeros((model.D_thetas,), dtype),
    )
    q = jnp.broadcast_to(q0, (NUM_CHAINS, q0.shape[0]))
    one = jnp.asarray(1.0, dtype)

    @jax.jit
    def run(q):
        def body(q, _):
            v, g = jax.vmap(lambda r: logp_grad(r, one))(q)
            # tiny state feedback serializes the evals and defeats DCE
            return q + jnp.asarray(1e-6, dtype) * g, v
        q, vs = jax.lax.scan(body, q, None, length=iters)
        return q, vs

    walls = []
    with jax.default_matmul_precision("highest"):
        jax.block_until_ready(run(q))          # compile
        for _ in range(repeats):
            t0 = time.time()
            jax.block_until_ready(run(q))
            walls.append(time.time() - t0)
    return iters * NUM_CHAINS / sorted(walls)[len(walls) // 2]


def main():
    import sys

    import jax

    from chip_smoke import card_name_and_power, require_gpu
    from magi_v2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devices = require_gpu(jax)
    card = card_name_and_power()
    peaks = peaks_for(devices[0].device_kind)
    import jax.numpy as jnp

    # Precision policy: setup (kernel matrices, pinv, hyperparameter MLE,
    # theta init) runs on CPU under a scoped jax.enable_x64 — handled
    # inside the library (config.setup_on_cpu). x64 stays off globally so
    # the f32 sampling graphs carry no incidental f64/int64 ops.

    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu.models import seir_f_vec
    from magi_v2_tpu.utils import summarize_chains
    from magi_v2_tpu.utils.data import load_seir_csv, simulate_ode

    try:
        ts_obs, X_obs, _ = load_seir_csv(t_max=4.0, d_obs=20)
        dataset = "reference CSV SEIR_seed=0 (load_seir_csv)"
    except FileNotFoundError:
        ts_obs, X_obs, _ = simulate_ode(
            seir_f_vec,
            x0=np.array([0.1, 0.05, 0.0]),
            thetas=np.array([6.0, 0.6, 1.8]),
            t_max=4.0,
            n_obs=81,
            noise_sd=0.005,
        )
        dataset = "simulated SEIR (simulate_ode, seed 0; reference CSV absent)"
    print(f"bench dataset: {dataset}", file=sys.stderr, flush=True)

    # float32 sampling dtype: the fast path (the f64 parity mode is tested
    # in CI).
    cfg = MagiConfig().replace(dtype=jnp.float32)
    model = MAGI_v2(
        D_thetas=3, ts_obs=ts_obs, X_obs=X_obs, bandsize=80,
        f_vec=seir_f_vec, config=cfg,
    )
    t0 = time.time()
    model.initial_fit(discretization=1)
    setup_s = time.time() - t0

    common = dict(
        num_chains=NUM_CHAINS,
        seed=0,
        init_jitter=0.01,
        # jittered fixed-length HMC keeps all 256 vmapped chains in lockstep
        # (no slowest-tree sync): measured faster than NUTS at identical
        # theta recovery and better R-hat on the previous accelerator
        algorithm="hmc",
        hmc_num_leapfrogs=HMC_LEAPFROGS,
        # full-state dense inverse mass estimated in the Welford window
        # (sampler/mass.py): rotates the X-theta ridge a diagonal cannot
        mass_matrix=MASS_MATRIX,
        # sample the same (tempered) posterior as the reference; the
        # library default is the statistically-sound warmup_only mode
        # (the true-posterior run below)
        anneal_mode="reference",
        # rescue the tempered warmup's long-L covariance misestimation
        # (see the operating-point note); the true-posterior run below
        # overrides this back to 0.0
        dense_shrinkage=TEMPERED_SHRINKAGE,
        # two-window staged mass adaptation, scales first (diag) then the
        # dense correlations from chains already mixing under them: kills
        # the 5-7x worst-seed ESS tail outright — 10-seed sweep ESS_min
        # 120k-131k, worst/median 1.02x, div <= 0.011% (results/
        # seir_seed_sweep_2win_diag1.json vs seir_seed_sweep.json's
        # 13k-100k); the true-posterior run below keeps the single-window
        # default (never fragile there)
        mass_window=(0.25, 0.45),
        mass_window2=(0.50, 0.72),
        mass_window1_diag=True,
    )

    # compile-priming: a full-length run, so the timed runs reuse its
    # executables (in-process and persistent compile cache)
    t0 = time.time()
    model.predict(num_results=NUM_RESULTS, num_burnin_steps=NUM_BURNIN,
                  **common)
    prime_s = time.time() - t0

    # median-of-5 timed runs: ESS_min is seed-stable but walls vary run to
    # run, so the headline ESS/s is the median with the min-max band in
    # the detail
    def timed_run(seed, **overrides):
        kw = dict(common, **overrides)
        kw["seed"] = seed
        t0 = time.time()
        res = model.predict(
            num_results=NUM_RESULTS, num_burnin_steps=NUM_BURNIN, **kw
        )
        wall = time.time() - t0
        s = summarize_chains(res["thetas_samps"], wall)
        s["wall_s"] = wall
        s["timings"] = res.get("timings")
        s["divergence_rate"] = float(
            res["kernel_results"]["divergences"].mean()
        )
        # Sampler-derived fused log-posterior+grad evals/sec/chip (the
        # second half of the BASELINE.json north-star metric): every HMC
        # leapfrog is exactly one fused eval. The stored per-draw leapfrog
        # counts share warmup's jitter distribution (one shared jittered
        # length per transition, sampler/run.py), so the sampling-phase
        # mean extends to the whole (burnin + results) wall.
        mean_L = float(res["kernel_results"]["num_leapfrogs"].mean())
        s["fused_evals_per_sec"] = (
            (NUM_BURNIN + NUM_RESULTS) * mean_L * NUM_CHAINS / wall
        )
        return s

    runs = [timed_run(seed) for seed in range(5)]
    walls = [r["wall_s"] for r in runs]
    ess_rates = sorted(r["ess_per_sec_min"] for r in runs)
    ess_per_sec = ess_rates[len(ess_rates) // 2]    # median of 5
    rhat_max = max(r["rhat_max"] for r in runs)
    ess_min = min(r["ess_min"] for r in runs)

    # Device-time ESS/s: one extra run with profile_timings=True records
    # PER-BLOCK walls under per-block device sync; n_blocks x min(block
    # wall) estimates steady-state device compute per phase (ESS_min /
    # device-compute-seconds). A profiler trace is the better source for
    # this number (ROADMAP Speed 1).
    prof = timed_run(10, profile_timings=True)
    tm = prof["timings"] or {}
    dev_s = band_dev = None
    wb, sb = tm.get("warmup_block_walls_s"), tm.get("block_walls_s")
    if wb and sb:
        dev_s = (tm.get("eps_init_s", 0.0)
                 + len(wb) * min(wb) + len(sb) * min(sb))
        ess_per_device_sec = prof["ess_min"] / dev_s
        # intra-run jitter band on the same estimator: median vs min
        med = (tm.get("eps_init_s", 0.0)
               + len(wb) * sorted(wb)[len(wb) // 2]
               + len(sb) * sorted(sb)[len(sb) // 2])
        band_dev = med / dev_s

    # the true-posterior datapoint (library default anneal_mode): the
    # tempered headline compares like-for-like with the reference, this one
    # certifies throughput on the statistically-sound target (at its own
    # measured-optimal trajectory length; see the operating-point note)
    true_post = timed_run(3, anneal_mode="warmup_only",
                          hmc_num_leapfrogs=TRUE_POST_LEAPFROGS,
                          dense_shrinkage=0.0,
                          mass_window=None, mass_window2=None,
                          mass_window1_diag=False)

    # Direct microbench of the same fused eval: N back-to-back vmapped
    # logp+grad calls at the bench geometry (precond/dense mode, the exact
    # function the sampler leapfrogs through, at the sampler's pinned
    # matmul precision), chained through the state so XLA cannot elide
    # them. Measures the eval kernel itself without HMC bookkeeping.
    micro_evals_per_sec = _microbench_fused_eval(model, jnp.float32)
    roofline = _roofline(model, jnp.float32, micro_evals_per_sec, peaks)

    print(json.dumps({
        "metric": "SEIR theta ESS/sec (min component, 256 chains, pooled)",
        "value": round(ess_per_sec, 3),
        "unit": "ESS/s",
        "card": card,
        "detail": {
            "dataset": dataset,
            "ess_per_sec_band_5_runs": [round(ess_rates[0], 1),
                                        round(ess_rates[-1], 1)],
            # steady-state device-compute estimate (per-block-min
            # extrapolation from the profiled run)
            "ess_per_device_sec": (
                round(ess_per_device_sec, 1) if dev_s else None
            ),
            "device_compute_s": round(dev_s, 2) if dev_s else None,
            "device_band_median_over_min": (
                round(band_dev, 3) if band_dev else None
            ),
            "profiled_run_ess_min": round(prof["ess_min"], 1),
            "ess_min": round(ess_min, 1),
            "rhat_max": round(rhat_max, 4),
            "converged": bool(rhat_max <= 1.05),
            "wall_s_per_run": [round(w, 2) for w in walls],
            "setup_s": round(setup_s, 2),
            "prime_s": round(prime_s, 2),
            "fresh_machine_note": (
                "first-ever run pays prime_s compile (cold persistent "
                "cache); steady-state cost is wall_s"
            ),
            "true_posterior_warmup_only": {
                "ess_per_sec_min": round(true_post["ess_per_sec_min"], 3),
                "ess_min": round(true_post["ess_min"], 1),
                "rhat_max": round(true_post["rhat_max"], 4),
                "wall_s": round(true_post["wall_s"], 2),
                "hmc_leapfrogs": TRUE_POST_LEAPFROGS,
                "fused_eval_per_sec_per_chip": round(
                    true_post["fused_evals_per_sec"], 1
                ),
            },
            # second north-star metric (BASELINE.json "ESS/sec; fused
            # log-posterior+grad evals/sec per chip"): sampler-derived =
            # leapfrogs x chains / sampling wall (median run);
            # microbench = chained vmapped evals without HMC bookkeeping
            "fused_eval_per_sec_per_chip": {
                "sampler_derived": round(sorted(
                    r["fused_evals_per_sec"] for r in runs
                )[1], 1),
                "microbench": round(micro_evals_per_sec, 1),
                "microbench_iters_x_chains": [2000, NUM_CHAINS],
            },
            # roofline accounting of the fused eval: XLA cost analysis x
            # measured evals/s vs the card's FP32 and HBM peaks
            "roofline": roofline,
            "num_chains": NUM_CHAINS,
            "steps": f"{NUM_BURNIN}+{NUM_RESULTS}",
            "hmc_leapfrogs": HMC_LEAPFROGS,
            "mass_matrix": MASS_MATRIX,
            "dense_shrinkage": TEMPERED_SHRINKAGE,
            "divergence_rate": runs[0]["divergence_rate"],
            "device": {"platform": devices[0].platform,
                       "kind": devices[0].device_kind,
                       "count": len(devices)},
        },
    }))


if __name__ == "__main__":
    main()
