"""SIRW end-to-end example — the intended workload of the reference's broken
smoke script (test_magi_script.py; fixed by intent per DEVIATIONS.md item 4:
D_thetas=5 to match the 5-parameter f_vec).

Data is simulated with the library's RK4 integrator (the reference script
read a hard-coded cluster path)."""

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--chains", type=int, default=1)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    from magi_v2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu.models import sirw_f_vec
    from magi_v2_tpu.utils.data import simulate_ode

    true_thetas = np.array([4.0, 1.0, 0.3, 0.5, 0.2])  # beta, phi, xi, chi, kappa
    ts_obs, X_obs, X_true = simulate_ode(
        sirw_f_vec,
        x0=np.array([0.95, 0.05, 0.0, 0.0]),
        thetas=true_thetas,
        t_max=8.0,
        n_obs=81,
        noise_sd=0.01,
    )

    cfg = MagiConfig()
    if args.quick:
        cfg = cfg.replace(hparam_num_iters=200, init_num_iters=1000)

    model = MAGI_v2(
        D_thetas=5, ts_obs=ts_obs, X_obs=X_obs, bandsize=200,
        f_vec=sirw_f_vec, config=cfg,
    )
    t0 = time.time()
    model.initial_fit(discretization=1, verbose=True)
    print(f"initial_fit: {time.time()-t0:.1f}s  theta_init={model.thetas_init}")

    steps = 200 if args.quick else 1000
    res = model.predict(
        num_results=steps, num_burnin_steps=steps,
        num_chains=args.chains, verbose=True, seed=0,
    )
    mean = res["thetas_samps"].mean(axis=tuple(range(res["thetas_samps"].ndim - 1)))
    print(f"theta posterior mean: {mean}")
    print(f"true thetas:          {true_thetas}")


if __name__ == "__main__":
    main()
