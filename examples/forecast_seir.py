"""Forecasting workflow: fit on t in [0, 4], forecast to t = 6 by extending
the grid with NaN-padded future points and refreshing the kernel matrices
(update_kernel_matrices; reference magi_v2.py:428-462)."""

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    from magi_v2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu import preprocess
    from magi_v2_tpu.models import seir_f_vec
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
    if args.quick:
        cfg = cfg.replace(hparam_num_iters=200, init_num_iters=1000)
    model = MAGI_v2(D_thetas=3, ts_obs=ts_obs, X_obs=X_obs, bandsize=80,
                    f_vec=seir_f_vec, config=cfg)
    model.initial_fit(discretization=1, verbose=True)
    steps = 100 if args.quick else 1000
    res_fit = model.predict(num_results=steps, num_burnin_steps=steps, seed=0)
    print("in-sample theta mean:", res_fit["thetas_samps"].mean(axis=0))

    # --- extend the grid to t_max_forecast with the same spacing
    t_forecast = 6.0
    dt = model.I[1, 0] - model.I[0, 0]
    I_new = np.arange(model.I[0, 0], t_forecast + dt / 2, dt)
    n_pad = len(I_new) - model.mag_I

    # NaN-pad the discretized observations (keeps the observation index
    # valid, magi_v2.py:428-431) and warm-start from the posterior mean
    model.X_obs_discret = np.vstack(
        [model.X_obs_discret, np.full((n_pad, model.D), np.nan)]
    )
    model.obs_index = preprocess.build_observation_index(model.X_obs_discret)
    X_mean = res_fit["X_samps"].mean(axis=0)
    pad = np.repeat(X_mean[-1:, :], n_pad, axis=0)
    model.Xhat_init = np.vstack([X_mean, pad])
    model.thetas_init = res_fit["thetas_samps"].mean(axis=0)
    model.sigma_sqs_init = res_fit["sigma_sqs_samps"].mean(axis=0)

    model.update_kernel_matrices(I_new, model.phi1s, model.phi2s)
    res_forecast = model.predict(num_results=steps, num_burnin_steps=steps,
                                 seed=1)
    X_f = res_forecast["X_samps"]
    lo, hi = np.quantile(X_f, [0.025, 0.975], axis=0)
    print(f"forecast grid: {model.mag_I} points to t={I_new[-1]:.2f}")
    print("forecast mean at horizon:", X_f.mean(axis=0)[-1])
    print("95% band at horizon:", lo[-1], hi[-1])


if __name__ == "__main__":
    main()
