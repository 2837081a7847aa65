"""Lorenz chaotic system on a dense discretization grid with many vmapped
chains (BASELINE.json configs[4]: N_I > 1000, 256 chains).

Grid-density note (measured): at N_I=513 theta recovery is essentially
exact — theta within 0.06% and trajectory coverage 1.0
(results/calibration_table.json) — with healthy step sizes (~0.16), so
use --n-obs 129 when the coarser resolution suffices. The N_I=1025 dense
grid's ACCURATE supported recipe is --storage hybrid (banded GN
whitening around the EXACT dense operators), no refresh, the reference
anneal schedule pinned at a 0.15 temperature floor, sigma pinned —
converged at theta (-1.35, +0.01, +0.09)%, coverage 1.0, rhat 1.0364,
ESS_min 3620 (results/lorenz1025_hybrid_r4c.json; 128 chains x
6000+4000 thin 2, L=64). The plain banded mode samples a BAND-TRUNCATED
approximation: the round-4 adjudication (DEVIATIONS.md #25-#26
"beta1_adjudication") showed its ~(-10, -3, -11)% theta offset is the
b=100 operator truncation (the exact beta=1 MAP is at truth to 0.6%;
63% of K^{-1}'s Frobenius mass is off-band at this density and no
affordable bandsize fixes it — initial_fit warns via
model.band_truncation). Exact-posterior beta=1 HMC stays intractable
there (K^{-1} stiffness grows ~h^-4, eps-collapse for any fixed metric;
DEVIATIONS.md #22) — for the beta=1
point answer use MAGI_v2.map_estimate() (exact operators, Laplace CIs,
minutes on CPU). The reference, with no preconditioning at all, cannot
sample this regime."""

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--algorithm", default="hmc", choices=["hmc", "nuts"])
    ap.add_argument("--storage", default="dense",
                    choices=["dense", "banded", "hybrid"],
                    help="banded = O(N_I*b) block-banded operators + banded "
                         "Gauss-Newton whitening (the max-scale mode; the "
                         "TARGET is band-truncated); hybrid = banded GN "
                         "whitening around the EXACT dense operators (the "
                         "accurate dense-grid mode)")
    ap.add_argument("--leapfrogs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=0,
                    help="override warmup/sampling steps (default 100 quick/500)")
    ap.add_argument("--n-obs", type=int, default=129,
                    help="observations (disc=2 -> N_I=4*(n-1)+1); 129 -> 513 "
                         "mixes well, 257 -> 1025 is the stress config")
    args = ap.parse_args()

    import jax

    from magi_v2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu.models import lorenz_f_vec
    from magi_v2_tpu.utils import summarize_chains
    from magi_v2_tpu.utils.data import simulate_ode

    true = np.array([10.0, 28.0, 8.0 / 3.0])
    n_obs = 33 if args.quick else args.n_obs
    ts_obs, X_obs, _ = simulate_ode(
        lorenz_f_vec,
        x0=np.array([-8.0, 7.0, 27.0]),
        thetas=true,
        t_max=2.0,
        n_obs=n_obs,
        noise_sd=0.5,
        substeps=50,
    )

    cfg = MagiConfig().replace(
        dtype=jnp.float64 if args.f64 else jnp.float32,
    )
    if args.quick:
        cfg = cfg.replace(hparam_num_iters=200, init_num_iters=1000)

    disc = 2  # N_I = 4*(n_obs-1)+1 > 1000 at full size
    model = MAGI_v2(
        D_thetas=3, ts_obs=ts_obs, X_obs=X_obs, bandsize=100,
        f_vec=lorenz_f_vec, config=cfg,
    )
    t0 = time.time()
    model.initial_fit(discretization=disc, verbose=True)
    print(f"initial_fit: {time.time()-t0:.1f}s  N_I={model.mag_I}  "
          f"theta_init={model.thetas_init}")

    steps = args.steps or (100 if args.quick else 500)
    t0 = time.time()
    res = model.predict(
        num_results=steps, num_burnin_steps=steps,
        num_chains=args.chains, verbose=True, seed=0, init_jitter=0.05,
        storage=args.storage,
        # bounded-leapfrog lockstep HMC: every chain runs the same number
        # of leapfrogs (NUTS depth-10 trees at this state dimension make
        # the whole vmapped batch wait for the deepest one)
        algorithm=args.algorithm, hmc_num_leapfrogs=args.leapfrogs,
    )
    wall = time.time() - t0
    theta = res["thetas_samps"]
    t3 = theta if args.chains > 1 else theta[:, None, :]
    print(f"theta posterior mean: {t3.mean(axis=(0,1))}  true: {true}")
    print("diagnostics:", summarize_chains(t3, wall))


if __name__ == "__main__":
    main()
