"""MAP-anchor probe for the dense-grid f32 collapse (round-5 fix).

results/stiffness_probe.json localized the Lorenz N_I=2049 eps collapse to
OFF-ANCHOR f32 evaluation noise: the relative-energy machinery
(posterior.RefPoint) makes the f32 error scale with the energy VARIATION
from the anchor, but its cross terms couple to the anchor's own residual
magnitudes (|a0| = |C^{-1/2}(x0 - mu)|, |s0|) — huge at the spline init
(GP-prior quadratic ~1e7) — and to the chains' whitened distance from the
anchor, which the tempered warmup's flattening grows without bound. This
probe measures, on CPU with the sampling dtype mirrored exactly (f32,
x64 off globally — the accelerator failure reproduces in this env):

1. the anchor residual magnitudes |a0|/|s0| at the init vs the f64 MAP
   (map_laplace.map_estimate, exact operators);
2. f32 ENERGY NOISE vs whitened distance from the anchor: at points
   z = z0 + s * N(0, I) (s = per-coordinate scatter in the banded-GN
   whitened coordinates, the sampler's own geometry), the spread of
   lp_f32(mode) - lp_f64(transliteration) — the quantity that destroys
   HMC acceptance when it reaches O(1) nats;
3. whitened-curvature lambda_max at the anchor (leapfrog eps_stable),
   beta 0.3 and 1.0 — does a MAP-anchored GN factor also tame the
   beta=1 stiffness that forced the tempering floor?

Run: python scripts/map_anchor_probe.py [--disc 2 3] [--out ...]
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
    ap.add_argument("--disc", type=int, nargs="+", default=[2, 3])
    ap.add_argument("--bandsize", type=int, default=100)
    ap.add_argument("--n-pts", type=int, default=8)
    ap.add_argument("--scatters", type=float, nargs="+",
                    default=[0.03, 0.1, 0.3, 1.0])
    ap.add_argument("--out", default="results/map_anchor_probe.json")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    # x64 OFF globally: mirrors the f32 sampling process (library setup scopes its
    # own enable_x64; the f32 sampling-path numerics reproduce on CPU)
    import jax.numpy as jnp

    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu.map_laplace import map_estimate
    from magi_v2_tpu.models import lorenz_f_vec
    from magi_v2_tpu.ops.linalg import sym_sqrt
    from magi_v2_tpu.posterior import softplus_inverse
    from magi_v2_tpu.sampler.magi_state import flatten_state
    from magi_v2_tpu.utils.data import simulate_ode

    true = np.array([10.0, 28.0, 8.0 / 3.0])
    ts_obs, X_obs, _ = simulate_ode(
        lorenz_f_vec, x0=np.array([-8.0, 7.0, 27.0]), thetas=true,
        t_max=2.0, n_obs=257, noise_sd=0.5, substeps=50,
    )
    SIG_FIX = 0.25

    def lam_max(mode_lp, q0, beta, iters=120, seed=0):
        g = lambda q: mode_lp(q, jnp.asarray(beta, q0.dtype))[1]
        hvp = jax.jit(lambda v: -jax.jvp(g, (q0,), (v,))[1])
        rng = np.random.default_rng(seed)
        v = jnp.asarray(rng.standard_normal(q0.shape), q0.dtype)
        v = v / jnp.linalg.norm(v)
        lam = 0.0
        for _ in range(iters):
            w = hvp(v)
            lam = float(v @ w)
            v = w / jnp.linalg.norm(w)
        return lam

    results = []
    for disc in args.disc:
        cfg = MagiConfig().replace(dtype=jnp.float32)
        model = MAGI_v2(D_thetas=3, ts_obs=ts_obs, X_obs=X_obs,
                        bandsize=args.bandsize, f_vec=lorenz_f_vec,
                        config=cfg)
        t0 = time.time()
        model.initial_fit(discretization=disc, verbose=False)
        setup_s = time.time() - t0
        N, D = model.mag_I, model.D
        dtype = cfg.dtype

        # ---- f64 MAP of the exact posterior (the anchor candidate);
        # cached under the same key scripts/lorenz1025_long.py --map-anchor
        # uses, so the sampling run skips the CPU solve
        cache = (f"results/lorenz_map_cache_N{model.mag_I}"
                 f"_b{args.bandsize}_s{SIG_FIX:g}.npz")
        t0 = time.time()
        if os.path.exists(cache):
            with np.load(cache) as z:
                mp = {"X_map": z["X_map"], "theta_map": z["theta_map"],
                      "converged": True, "lbfgs_iters": 0}
            print(f"map: loaded {cache}", flush=True)
        else:
            mp = map_estimate(model, sigma_sqs_fixed=SIG_FIX, laplace=False,
                              verbose=True)
            os.makedirs("results", exist_ok=True)
            np.savez_compressed(cache, X_map=mp["X_map"],
                                theta_map=mp["theta_map"])
        map_s = time.time() - t0

        # ---- f64 transliteration of the (exact-operator) log-posterior,
        # sigma pinned — ground truth for the noise measurement
        with model._setup_device_ctx():
            Ce, me, Ke = model._exact_operators() if model.BANDSIZE \
                else (model.C_d_invs, model.m_ds, model.K_d_invs)
            R64 = np.asarray(sym_sqrt(jnp.asarray(Ce)))
            S64 = np.asarray(sym_sqrt(jnp.asarray(Ke)))
            m64 = np.asarray(me, np.float64)
        mu64 = np.asarray(model.mu_ds, np.float64)
        oi = model.obs_index
        sig_lb = np.minimum(
            (np.asarray(model.Xhat_init).std(axis=0)
             * cfg.sigma_sq_lb_scale) ** 2,
            0.5 * SIG_FIX,
        )
        sig_pre_fix64 = np.log(np.expm1(SIG_FIX - sig_lb))
        beta_prior = float(model.beta)

        def f_vals64(X, th):
            with model._setup_device_ctx():
                return np.asarray(
                    model.f_vec(jnp.asarray(np.asarray(model.I, np.float64)),
                                jnp.asarray(np.asarray(X, np.float64)),
                                jnp.asarray(np.asarray(th, np.float64))),
                    np.float64,
                )

        def lp64(X, th_pre, beta):
            X = np.asarray(X, np.float64)
            th_pre = np.asarray(th_pre, np.float64)
            th = np.logaddexp(0.0, th_pre)          # softplus
            xc = (X - mu64[None, :]).T              # (D, N)
            t1 = float(sum(
                np.sum((R64[d] @ xc[d]) ** 2) for d in range(D)
            ))
            f = f_vals64(X, th).T                   # (D, N)
            r = f - np.einsum("dnm,dm->dn", m64, xc)
            t2 = float(sum(
                np.sum((S64[d] @ r[d]) ** 2) for d in range(D)
            ))
            sig = np.logaddexp(0.0, sig_pre_fix64) + sig_lb
            t3 = float(np.sum(np.asarray(oi.N_ds, np.float64)
                              * np.log(2.0 * np.pi * sig)))
            x_obs = X.reshape(-1)[np.asarray(oi.not_nan_idxs)]
            iv = (1.0 / sig)[np.asarray(oi.not_nan_cols)]
            t4 = float(np.sum((x_obs - np.asarray(oi.y_observed,
                                                  np.float64)) ** 2 * iv))
            ljs = float(np.sum(-np.logaddexp(0.0, -sig_pre_fix64)))
            ljt = float(np.sum(-np.logaddexp(0.0, -th_pre)))
            return beta * (-0.5 * ((t1 + t2) / beta_prior + t3 + t4)
                           + ljs + ljt)

        row = {
            "N_I": int(N), "bandsize": args.bandsize,
            "setup_s": round(setup_s, 1),
            "theta_init": [round(float(v), 3) for v in model.thetas_init],
            "map": {
                "theta_map": [round(float(v), 4) for v in mp["theta_map"]],
                "theta_rel_err": [
                    round(float(v), 4)
                    for v in (mp["theta_map"] - true) / true
                ],
                "converged": bool(mp["converged"]),
                "lbfgs_iters": int(mp["lbfgs_iters"]),
                "wall_s": round(map_s, 1),
            },
            "anchors": {},
        }

        for name, (aX, ath) in {
            "init": (np.asarray(model.Xhat_init, np.float64),
                     np.asarray(model.thetas_init, np.float64)),
            "map": (np.asarray(mp["X_map"], np.float64),
                    np.asarray(mp["theta_map"], np.float64)),
        }.items():
            mode, *_ = model._build_sampling_setup(
                "precond", "hybrid", dtype, sigma_sqs_fixed=SIG_FIX,
                gn_anchor={"X": aX, "thetas": ath},
            )
            ref = mode.gn["ref"]
            arow = {
                # the f32-noise coupling magnitudes (see posterior.RefPoint)
                "a0_rms": float(f"{float(np.sqrt(np.mean(np.asarray(ref.a0, np.float64) ** 2))):.4g}"),
                "s0_rms": float(f"{float(np.sqrt(np.mean(np.asarray(ref.s0, np.float64) ** 2))):.4g}"),
                "t1_anchor": float(f"{float(np.sum(np.asarray(ref.a0, np.float64) ** 2)):.4g}"),
                "t2_anchor": float(f"{float(np.sum(np.asarray(ref.s0, np.float64) ** 2)):.4g}"),
            }
            th_pre_anchor = np.asarray(
                softplus_inverse(jnp.asarray(np.maximum(ath, 1e-6),
                                             jnp.float64))
            )
            q_anchor = jnp.asarray(flatten_state(
                mode.X0,
                jnp.zeros((D,), dtype),   # pinned — value irrelevant
                jnp.asarray(th_pre_anchor, dtype),
            ))
            for beta in (0.3, 1.0):
                lam = lam_max(mode.logp_grad, q_anchor, beta)
                arow[f"lam_max_beta{beta}"] = float(f"{lam:.4g}")
                arow[f"eps_stable_beta{beta}"] = float(
                    f"{2.0 / np.sqrt(max(lam, 1e-300)):.4g}"
                )

            # f32 energy noise vs whitened distance from the anchor:
            # points z = z0 + s*N(0,I), theta_pre = anchor + 0.05*N
            rng = np.random.default_rng(42)
            z0 = np.asarray(mode.X0, np.float64).reshape(-1)
            noise = {}
            for s in args.scatters:
                d32, d64 = [], []
                for i in range(args.n_pts):
                    z = z0 + s * rng.standard_normal(z0.shape)
                    th_pre = th_pre_anchor + 0.05 * rng.standard_normal(3)
                    # natural X for the f64 ground truth: the mode's own
                    # exact f64 back-substitution of the whitened point
                    dz = (z - z0).reshape(N, D)
                    from magi_v2_tpu.sampler.precond import unwhiten_Z_banded
                    with model._setup_device_ctx(), \
                         jax.default_matmul_precision("highest"):
                        dX = np.asarray(unwhiten_Z_banded(
                            jnp.asarray(dz[None]),
                            jnp.zeros((D,), jnp.float64),
                            jnp.asarray(np.asarray(mode.factor[0],
                                                   np.float64)),
                        ))[0]
                    Xn = aX + dX
                    q = jnp.asarray(flatten_state(
                        jnp.asarray(z.reshape(N, D), dtype),
                        jnp.zeros((D,), dtype),
                        jnp.asarray(th_pre, dtype),
                    ))
                    with jax.default_matmul_precision("highest"):
                        v32 = float(mode.logp_grad(
                            q, jnp.asarray(0.3, dtype))[0])
                    d32.append(v32)
                    d64.append(lp64(Xn, th_pre, 0.3))
                diff = np.asarray(d32) - np.asarray(d64)
                noise[f"s{s}"] = {
                    "lp_noise_sd": float(f"{float(np.std(diff)):.4g}"),
                    "lp64_spread": float(f"{float(np.std(d64)):.4g}"),
                    "lp64_mean": float(f"{float(np.mean(d64)):.4g}"),
                }
            arow["f32_noise_beta0.3"] = noise
            row["anchors"][name] = arow
            print(json.dumps({name: arow}, indent=1), flush=True)

        results.append(row)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    print(json.dumps(results, indent=1), flush=True)


if __name__ == "__main__":
    main()
