"""SEIR end-to-end example — the vignette workload (vignette.ipynb).

Usage: python examples/seir.py [--quick] [--chains N] [--f32]
"""

import argparse
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="reduced iterations")
    ap.add_argument("--chains", type=int, default=1)
    ap.add_argument("--f32", action="store_true", help="float32 fast mode")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    from magi_v2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if not args.f32:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu.models import seir_f_vec
    from magi_v2_tpu.utils import summarize_chains
    from magi_v2_tpu.utils.data import load_seir_csv, simulate_ode

    try:
        ts_obs, X_obs, _ = load_seir_csv(t_max=4.0, d_obs=20)
        print("dataset: reference CSV SEIR_seed=0 (load_seir_csv)")
    except FileNotFoundError:
        ts_obs, X_obs, _ = simulate_ode(
            seir_f_vec, x0=np.array([0.1, 0.05, 0.0]),
            thetas=np.array([6.0, 0.6, 1.8]), t_max=4.0, n_obs=81,
            noise_sd=0.005,
        )
        print("dataset: simulated SEIR (simulate_ode, seed 0) — the "
              "reference CSV is absent")

    cfg = MagiConfig()
    if args.f32:
        cfg = cfg.replace(dtype=jnp.float32)
    if args.quick:
        cfg = cfg.replace(hparam_num_iters=200, init_num_iters=1000)

    model = MAGI_v2(
        D_thetas=3, ts_obs=ts_obs, X_obs=X_obs, bandsize=80,
        f_vec=seir_f_vec, config=cfg,
    )
    t0 = time.time()
    model.initial_fit(discretization=1, verbose=True)
    print(f"initial_fit: {time.time()-t0:.1f}s  theta_init={model.thetas_init}")

    steps = 200 if args.quick else 1000
    t0 = time.time()
    res = model.predict(
        num_results=steps, num_burnin_steps=steps,
        num_chains=args.chains, verbose=True, seed=0,
        init_jitter=0.01 if args.chains > 1 else 0.0,
    )
    wall = time.time() - t0

    theta = res["thetas_samps"]
    mean = theta.mean(axis=(0, 1) if args.chains > 1 else 0)
    print(f"theta posterior mean: {mean}  (true: 6.0 0.6 1.8; "
          f"reference vignette recovered 5.831 0.565 1.77)")
    t3 = theta if args.chains > 1 else theta[:, None, :]
    print("diagnostics:", summarize_chains(t3, wall))
    return res


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
