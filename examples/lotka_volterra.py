"""Lotka-Volterra predator-prey end-to-end example (registry
'lotka_volterra'; no reference counterpart — the reference ships only
SEIR/SIRW workloads, vignette.ipynb cell 3 / test_magi_script.py:19-45).

Closed LV orbits make this the friendliest multi-parameter recovery demo:
even a --quick run lands theta within a few percent (the round-4 drive
measured ~1% at 4x100+100 with --cpu, i.e. CPU f64 — the configuration
this script runs under that flag).
"""

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    from magi_v2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        # f64 sampling on the CPU; the accelerator run samples in f32 with
        # x64 off, so its graphs carry no incidental f64 ops
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu.models import MODEL_REGISTRY, lotka_volterra_f_vec
    from magi_v2_tpu.utils.data import simulate_ode

    true_thetas = np.array(MODEL_REGISTRY["lotka_volterra"].true_thetas)
    ts_obs, X_obs, X_true = simulate_ode(
        lotka_volterra_f_vec,
        x0=np.array([1.0, 1.0]),
        thetas=true_thetas,
        t_max=10.0,
        n_obs=41,
        noise_sd=0.1,
        substeps=200,
        seed=0,
    )

    # f64 sampling on CPU (x64 enabled above); f32 on the accelerator.
    cfg = MagiConfig() if args.cpu else MagiConfig().replace(dtype=jnp.float32)
    if args.quick:
        cfg = cfg.replace(hparam_num_iters=200, init_num_iters=1000)

    model = MAGI_v2(
        D_thetas=4, ts_obs=ts_obs, X_obs=X_obs, bandsize=None,
        f_vec=lotka_volterra_f_vec, config=cfg,
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
    print(f"true thetas (a,b,c,d): {true_thetas}")


if __name__ == "__main__":
    main()
