"""Per-leapfrog cost ablation of the hybrid (exact-operator) sampling mode.

At Lorenz N_I=1025 a hybrid leapfrog has cost far more per chain than a
banded (truncated-target) one — more than a roofline estimate of its
extra dense matvecs (6 batched N^2 matvecs) explains. This probe times
the leapfrog's constituent ops in isolation, each wrapped in a
lax.scan of --reps iterations inside ONE jit (so per-dispatch latency is
amortized as in the real sampler's scans):

  hybrid_logp_grad   the full fused eval the hybrid leapfrog pays
  banded_logp_grad   the banded mode's eval (baseline)
  dense_matvec_x6    6 batched (D, N, N) @ (D, N) einsum matvecs
  banded_solve_vjp   block-banded triangular solve + its VJP
  fvec_only          the ODE RHS evaluation
  given_t1_dense     log_posterior_given_t1 through the dense operators
                     (no solve) + grad

Writes one JSON to results/hybrid_perf_probe.json with per-rep ms for
each component at each chain count. Run on the GPU (default platform);
use --cpu --n-obs 17 for a quick correctness pass.
"""

import argparse
import json
import os
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--reps", type=int, default=200,
                    help="scan length inside one jit per timed call")
    ap.add_argument("--n-obs", type=int, default=257)
    ap.add_argument("--discretization", type=int, default=2)
    ap.add_argument("--bandsize", type=int, default=100)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="results/hybrid_perf_probe.json")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu.models import lorenz_f_vec
    from magi_v2_tpu.sampler.magi_state import flatten_state
    from magi_v2_tpu.utils.data import simulate_ode

    dtype = jnp.float32

    ts_obs, X_obs, _ = simulate_ode(
        lorenz_f_vec,
        x0=np.array([-8.0, 7.0, 27.0]),
        thetas=np.array([10.0, 28.0, 8.0 / 3.0]),
        t_max=2.0,
        n_obs=args.n_obs,
        noise_sd=0.5,
        substeps=20,
    )
    model = MAGI_v2(
        D_thetas=3, ts_obs=ts_obs, X_obs=X_obs, bandsize=args.bandsize,
        f_vec=lorenz_f_vec, config=MagiConfig().replace(dtype=dtype),
    )
    t0 = time.time()
    model.initial_fit(discretization=args.discretization, verbose=False)
    setup_s = time.time() - t0
    N_I, D, D_th = model.mag_I, model.D, model.D_thetas
    print(f"initial_fit {setup_s:.1f}s  N_I={N_I}", flush=True)

    mode_h, data_h, _, _, _ = model._build_sampling_setup(
        "precond", "hybrid", dtype
    )
    mode_b, _, _, _, _ = model._build_sampling_setup(
        "precond", "banded", dtype
    )

    from magi_v2_tpu.ops.banded import (
        block_banded_triangular_solve_upper,
    )
    from magi_v2_tpu.posterior import log_posterior_given_t1

    dim = N_I * D + D + D_th
    q0 = flatten_state(
        mode_h.X0,
        jnp.zeros((D,), dtype),
        jnp.zeros((D_th,), dtype),
    )

    C_sq = jnp.asarray(data_h.C_inv_sqrts, dtype)
    K_sq = jnp.asarray(data_h.K_inv_sqrts, dtype)
    m_ds = jnp.asarray(data_h.m_ds, dtype)
    beta1 = jnp.asarray(1.0, dtype)

    # --- component closures (single-chain; vmapped over the chain axis) ---
    def hybrid_lg(q):
        v, g = mode_h.logp_grad(q, beta1)
        return v, g

    def banded_lg(q):
        v, g = mode_b.logp_grad(q, beta1)
        return v, g

    def dense_matvec_x6(q):
        X = q[: N_I * D].reshape(N_I, D).T        # (D, N)
        acc = jnp.zeros((), dtype)
        for A in (C_sq, m_ds, K_sq):
            y = jnp.einsum("dnm,dm->dn", A, X)
            acc = acc + jnp.sum(y * y)
            z = jnp.einsum("dnm,dm->dn", A, X + acc * 1e-30)
            acc = acc + jnp.sum(z)
        return acc, jnp.zeros_like(q)

    U_blocks = mode_h.gn["U_blocks"]
    diag_inv = mode_h.gn["U_dinv"]

    def solve_vjp(q):
        z = q[: N_I * D]

        def f(zz):
            x = block_banded_triangular_solve_upper(
                U_blocks, zz, diag_inv=diag_inv
            )
            return jnp.sum(x * x)

        v, g = jax.value_and_grad(f)(z)
        return v, jnp.concatenate([g, q[N_I * D:]])

    def fvec_only(q):
        X = q[: N_I * D].reshape(N_I, D)
        th = jax.nn.softplus(q[-D_th:])
        f = lorenz_f_vec(data_h.I, X, th)
        return jnp.sum(f * f), jnp.zeros_like(q)

    def given_t1_dense(q):
        def f(qq):
            X = qq[: N_I * D].reshape(N_I, D)
            sp = qq[N_I * D: N_I * D + D]
            tp = qq[-D_th:]
            Xc = (X - data_h.mu_ds[None, :]).T
            t1 = jnp.sum(jnp.einsum("dnm,dm->dn", C_sq, Xc) ** 2)
            return log_posterior_given_t1(
                data_h, lorenz_f_vec, X, sp, tp, beta1, t1
            )

        return jax.value_and_grad(f)(q)

    components = {
        "hybrid_logp_grad": hybrid_lg,
        "banded_logp_grad": banded_lg,
        "dense_matvec_x6": dense_matvec_x6,
        "banded_solve_vjp": solve_vjp,
        "fvec_only": fvec_only,
        "given_t1_dense": given_t1_dense,
    }

    def timed(fn, C):
        """scan of reps data-dependent calls inside one jit; per-rep ms."""
        vfn = jax.vmap(fn)

        @jax.jit
        def run(qs):
            def body(carry, _):
                v, g = vfn(carry)
                # data dependence so XLA cannot hoist the body out
                carry = carry + 1e-30 * (
                    g if g.shape == carry.shape
                    else jnp.broadcast_to(v[:, None], carry.shape)
                )
                return carry, v[0]

            out, vs = jax.lax.scan(body, qs, None, length=args.reps)
            return out.sum() + vs.sum()

        qs = jnp.broadcast_to(q0, (C, dim)) + 0.0
        r = run(qs)
        r.block_until_ready()          # compile + warm
        best = np.inf
        for _ in range(3):
            t0 = time.time()
            run(qs).block_until_ready()
            best = min(best, time.time() - t0)
        return best / args.reps * 1e3  # ms per rep

    results = {
        "what": ("per-leapfrog component ablation of the hybrid mode, "
                 "ms per rep (scan inside one jit, best of 3)"),
        "N_I": N_I, "bandsize": args.bandsize, "reps": args.reps,
        "dtype": "float32",
        "device": str(jax.devices()[0].device_kind)
        if not args.cpu else "cpu",
        "cells": {},
    }
    for C in args.chains:
        cell = {}
        for name, fn in components.items():
            ms = timed(fn, C)
            cell[name] = round(ms, 4)
            print(f"chains={C:4d}  {name:20s} {ms:8.3f} ms/rep", flush=True)
        results["cells"][str(C)] = cell

    os.makedirs("results", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
