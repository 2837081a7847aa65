"""Protein-transduction end-to-end example (registry
'protein_transduction'; no reference counterpart — the reference ships
only SEIR/SIRW workloads, vignette.ipynb cell 3 / test_magi_script.py:19-45).

Vyshemirsky & Girolami (2008) model 1 — the hard benchmark of the ODE
gradient-matching literature (stiff decay + a Michaelis-Menten
nonlinearity). All five states observed on a uniform grid. What recovery
to expect (measured, results/protein_probe.json — the MAP/Laplace
identification probe at this exact design): k1 and k4 are sharp (MAP at
truth, |z| < 0.7); (V, Km) individually sit on the certified MM ridge
(z < 1 only because the Laplace sds are wide; only the near-linear-regime
slope is informed); and (k2, k3) carry a correlated posterior-intrinsic
offset (the S*R / S_R balance admits a compensating direction) — the
MAGI posterior's own mode is there, so the sampler reporting it is
correct behavior, same class as the SEIR/SIRW R offsets
(results/r_offset_validation.json, results/sirw_r_coverage_probe.json).
"""

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--chains", type=int, default=8)
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
    from magi_v2_tpu.models import MODEL_REGISTRY, protein_transduction_f_vec
    from magi_v2_tpu.utils.data import simulate_ode

    spec = MODEL_REGISTRY["protein_transduction"]
    true_thetas = np.array(spec.true_thetas)  # (k1,k2,k3,k4,V,Km)
    # V&G initial condition: S=1, R=1, everything downstream empty. The
    # transient (S->S_R->R_pp hand-off) lives in t < ~30; t_max=60 also
    # shows the slow V-driven recovery of R.
    ts_obs, X_obs, X_true = simulate_ode(
        protein_transduction_f_vec,
        x0=np.array([1.0, 0.0, 1.0, 0.0, 0.0]),
        thetas=true_thetas,
        t_max=60.0,
        n_obs=61,
        noise_sd=0.01,
        substeps=100,
        seed=0,
    )

    # f64 sampling on CPU (x64 enabled above); f32 on the accelerator.
    cfg = MagiConfig() if args.cpu else MagiConfig().replace(dtype=jnp.float32)
    if args.quick:
        cfg = cfg.replace(hparam_num_iters=200, init_num_iters=1000)

    model = MAGI_v2(
        D_thetas=6, ts_obs=ts_obs, X_obs=X_obs, bandsize=None,
        f_vec=protein_transduction_f_vec, config=cfg,
    )
    t0 = time.time()
    model.initial_fit(discretization=1, verbose=True)
    print(f"initial_fit: {time.time()-t0:.1f}s  theta_init={model.thetas_init}")

    # lockstep HMC + auto (dense-tail) metric: the README small-state
    # recipe. Default NUTS hits depth ~10 on the stiff S-decay directions
    # here; fixed-length HMC under the dense metric is ~8x cheaper.
    steps = 200 if args.quick else 1000
    res = model.predict(
        num_results=steps, num_burnin_steps=steps,
        num_chains=args.chains, verbose=True, seed=0,
        algorithm="hmc", hmc_num_leapfrogs=128, mass_matrix="auto",
        init_jitter=0.01,
    )
    th = np.asarray(res["thetas_samps"]).reshape(-1, 6)
    mean, sd = th.mean(0), th.std(0)
    names = spec.theta_names
    print(f"{'param':>6} {'true':>8} {'post mean':>10} {'post sd':>9}")
    for i, n in enumerate(names):
        print(f"{n:>6} {true_thetas[i]:8.3f} {mean[i]:10.4f} {sd[i]:9.4f}")
    ratio = th[:, 4] / th[:, 5]
    print(f"MM-ridge slope V/Km: true {true_thetas[4]/true_thetas[5]:.4f}  "
          f"post {ratio.mean():.4f} +/- {ratio.std():.4f}  "
          "(V, Km individually ride the certified flat direction)")


if __name__ == "__main__":
    main()
