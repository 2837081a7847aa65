#!/usr/bin/env python3
"""Run MAGI's main path once on an NVIDIA GPU and check what comes out.

    python chip_smoke.py              # phases 0-4 on one GPU
    python chip_smoke.py --four-gpus  # phase 5 only: chains sharded over 4

Every phase prints one JSON line naming the card; the last line is
``{"ok": true, "device": {...}}`` only when every phase passed. Without a
GPU, or without the rest of the repository beside this file, the script
exits non-zero and prints no result.

0. device: JAX's default backend must be the GPU (no CPU fallback); the
   CPU backend must stay available too, because setup runs there.
1. parity: each device op of the main path against its plain reference at
   the repository's real widths — in float64, in float32 at "highest"
   matmul precision (what the sampler pins), and, printed beside it, in
   float32 at default precision (TF32 on this card) — plus the device time
   XLA's own code takes for each op.
2. SEIR through the public API: initial_fit, the benchmark recipe (f32,
   256 chains, HMC), predict()'s defaults (NUTS, f64, progress callback)
   and map_estimate().
3. initial_fit in f64 on the GPU (setup_on_cpu=False) against the CPU
   setup of phase 2.
4. dense grid: Lorenz N_I=1025, hybrid storage, and its log density
   against the NumPy transliteration of the posterior and against the
   centered dense posterior.
5. (--four-gpus) run_nuts_chains_sharded over a 1-D mesh of four GPUs
   against the same call on one GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# profiler traces are written here and removed once read
TRACE_DIR = os.path.join(HERE, ".jax_traces")

SEIR_THETA = (6.0, 0.6, 1.8)
LORENZ_THETA = (10.0, 28.0, 8.0 / 3.0)


# ---------------------------------------------------------------------------
# device, card and output helpers
# ---------------------------------------------------------------------------

def card_name_and_power() -> str:
    """``name, power.limit`` of every card, from nvidia-smi in a child
    process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return "; ".join(
        line.strip() for line in out.stdout.splitlines() if line.strip()
    )


def require_gpu(jax, count: int = 1):
    """Fail unless JAX's default backend is the GPU with >= count devices
    and the CPU backend (used by setup) is available beside it."""
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        raise RuntimeError(
            f"JAX_PLATFORMS={platforms!r} leaves out the CPU backend that "
            "setup runs on; leave it unset or use 'cuda,cpu'"
        )
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"no GPU: JAX's default backend is {backend!r}")
    devs = jax.devices()
    if len(devs) < count:
        raise RuntimeError(f"need {count} GPUs, JAX sees {len(devs)}")
    jax.devices("cpu")
    return devs


def _num(x):
    x = float(x)
    return x if np.isfinite(x) else str(x)


def emit(phase: str, card: str, **fields):
    print(json.dumps({"phase": phase, "card": card, **fields},
                     default=_num), flush=True)


def check(name, err, tol, reason, failures):
    """One parity record; appends to ``failures`` when the error is not
    within its tolerance."""
    ok = bool(np.isfinite(err) and err <= tol)
    if not ok:
        failures.append(f"{name}: {err:.3e} > {tol:.1e}")
    return {"err": _num(err), "tol": tol, "ok": ok, "reason": reason}


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def peak_bytes(jax):
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def gpu_trace_events(jax, fn, reps: int):
    """(name, start_ns, end_ns) of every event on the GPU planes of a
    profiler trace of ``reps`` calls of ``fn`` (host and Python tracers
    off). Empty when the trace has no GPU plane (CPU runs)."""
    opts = jax.profiler.ProfileOptions()
    opts.host_tracer_level = 0
    opts.python_tracer_level = 0
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    with jax.profiler.trace(TRACE_DIR, profiler_options=opts):
        for _ in range(reps):
            jax.block_until_ready(fn())
    events = []
    for path in glob.glob(os.path.join(TRACE_DIR, "**", "*.xplane.pb"),
                          recursive=True):
        for plane in jax.profiler.ProfileData.from_file(path).planes:
            if plane.name.startswith("/device:GPU"):
                events.extend((e.name, e.start_ns, e.end_ns)
                              for line in plane.lines for e in line.events)
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    return events


def device_time_ms(jax, fn, args, reps: int = 10):
    """Per-call device time of warm ``fn(*args)``: the union of the GPU's
    event intervals over ``reps`` calls, divided by ``reps``. None on a
    trace without a GPU plane."""
    jax.block_until_ready(fn(*args))
    spans = sorted((lo, hi) for _, lo, hi in
                   gpu_trace_events(jax, lambda: fn(*args), reps))
    if not spans:
        return None
    busy, (cur_lo, cur_hi) = 0, spans[0]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    return busy / reps / 1e6


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def seir_data(n_obs: int = 81):
    from magi_v2_tpu.models import seir_f_vec
    from magi_v2_tpu.utils.data import simulate_ode

    ts, X, X_true = simulate_ode(
        seir_f_vec, x0=np.array([0.1, 0.05, 0.0]),
        thetas=np.array(SEIR_THETA), t_max=4.0, n_obs=n_obs,
        noise_sd=0.005,
    )
    return ts, X, X_true


def lorenz_data(n_obs: int = 257):
    from magi_v2_tpu.models import lorenz_f_vec
    from magi_v2_tpu.utils.data import simulate_ode

    return simulate_ode(
        lorenz_f_vec, x0=np.array([-8.0, 7.0, 27.0]),
        thetas=np.array(LORENZ_THETA), t_max=2.0, n_obs=n_obs,
        noise_sd=0.5, substeps=50,
    )


def fit_seir(dtype, n_obs: int = 81, **cfg):
    """MAGI_v2 on the SEIR vignette data after initial_fit; returns
    (model, setup seconds)."""
    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu.models import seir_f_vec

    ts, X, _ = seir_data(n_obs)
    model = MAGI_v2(
        D_thetas=3, ts_obs=ts, X_obs=X, bandsize=80, f_vec=seir_f_vec,
        config=MagiConfig().replace(dtype=dtype, **cfg),
    )
    t0 = time.time()
    model.initial_fit(discretization=1)
    return model, time.time() - t0


def _pre(vals, lower):
    """predict()'s inverse-softplus initial-state map (magi_v2.py:374-383)."""
    from magi_v2_tpu.posterior import softplus_inverse

    vals, lower = np.asarray(vals, np.float64), np.asarray(lower, np.float64)
    out = np.full_like(vals, -5.0)
    above = vals > lower
    out[above] = np.asarray(softplus_inverse(vals[above] - lower[above]))
    return out


def sigma_lb(model):
    return (model.Xhat_init.std(axis=0) * model.config.sigma_sq_lb_scale) ** 2


# ---------------------------------------------------------------------------
# phase 1: parity of each device op
# ---------------------------------------------------------------------------

def _three_precisions(jax, run, ref, err_fn):
    """err_fn(run(dtype), ref) in f64, f32-highest and f32-default."""
    import jax.numpy as jnp

    with jax.enable_x64(True):
        e64 = err_fn(run(jnp.float64), ref)
    with jax.default_matmul_precision("highest"):
        e32 = err_fn(run(jnp.float32), ref)
    with jax.default_matmul_precision("default"):
        e32d = err_fn(run(jnp.float32), ref)
    return e64, e32, e32d


def parity_bessel(jax, n_z: int, failures, time_ops: bool = True):
    import jax.numpy as jnp
    import scipy.special as sps

    from magi_v2_tpu.ops.bessel import kv

    z64 = np.geomspace(1e-3, 40.0, n_z)
    f = jax.jit(lambda z: kv(2.01, z))

    def run(dt):
        z = jnp.asarray(z64, dt)
        # reference at the dtype-rounded inputs: isolates kv's own error
        ref = sps.kv(2.01, np.asarray(z, np.float64))
        return np.asarray(f(z), np.float64), ref

    rel = lambda out, _: float(np.max(np.abs(out[0] - out[1]) / out[1]))
    e64, e32, e32d = _three_precisions(jax, run, None, rel)
    rec = {
        "op": "ops.bessel.kv(2.01, z)", "width": n_z,
        "reference": "scipy.special.kv",
        "f64": check("kv f64", e64, 1e-11,
                     "elementwise relative; the CPU test holds 5e-13 and "
                     "the series/CF2 sums amplify a few-ulp f64 "
                     "transcendental error by < 1e2", failures),
        "f32_highest": check("kv f32", e32, 2e-5,
                             "elementwise relative; 40 series / 160 CF2 "
                             "terms of ~ulp f32 rounding (eps 1.2e-7)",
                             failures),
        "f32_default_tf32": {"err": _num(e32d),
                             "note": "no matmul in kv: TF32 does not apply"},
    }
    if time_ops:
        with jax.enable_x64(True):
            rec["device_ms_f64"] = device_time_ms(
                jax, f, (jnp.asarray(z64),))
    return rec


# f64 tolerances of the Toeplitz build against the pairwise one, per grid
# width: (m, relative Frobenius; K, Frobenius relative to ||C''||). Each
# sits above the CPU Toeplitz-vs-pairwise reading (printed beside it as
# cpu_err) and the H100's, which repeats exactly from run to run, by a
# factor of 2-7. H100: m 2.8e-8 / 4.6e-6, K 9.6e-9 / 1.4e-6 at N_I=161 /
# 1025. CPU: m 1.4e-8, K 5.8e-9 at 161 (1.5e-8 on the SEIR fit made with
# x64 on); exactly 0 at 1025, whose spacing 2^-9 makes both builds see
# bit-identical distances.
KERNEL_F64_TOLS = {161: (2e-7, 5e-8), 1025: (2e-5, 3e-6)}


def parity_kernel_matrices(jax, n_i: int, t_max: float, phi1: float,
                           phi2: float, tols, failures,
                           time_ops: bool = True):
    """``tols``: the (m, K) f64 tolerances at this width (KERNEL_F64_TOLS)."""
    import jax.numpy as jnp

    from magi_v2_tpu.ops.kernels import (
        magi_kernel_matrices, matern_derivative_matrices,
    )

    I = np.linspace(0.0, t_max, n_i)
    h = float(I[1] - I[0])
    cpu = jax.devices("cpu")[0]
    toe = jax.jit(
        lambda I, p1, p2: magi_kernel_matrices(I, p1, p2, spacing=h)
    )

    def run(dt):
        return [np.asarray(a, np.float64) for a in toe(
            jnp.asarray(I, dt), jnp.asarray(phi1, dt), jnp.asarray(phi2, dt)
        )]

    with jax.enable_x64(True), jax.default_device(cpu):
        ref = [np.asarray(a) for a in jax.jit(
            lambda I: magi_kernel_matrices(I, phi1, phi2)
        )(jnp.asarray(I))]
        kpp_norm = float(np.linalg.norm(np.asarray(jax.jit(
            lambda I: matern_derivative_matrices(I, phi1, phi2)[2]
        )(jnp.asarray(I)))))
        cpu_out = run(jnp.float64)

    errs = lambda out, ref: (
        rel_max(out[0], ref[0]), rel_fro(out[1], ref[1]),
        float(np.linalg.norm(out[2] - ref[2])) / kpp_norm,
        rel_fro(out[2], ref[2]))
    e_cpu = errs(cpu_out, ref)
    e64, e32, e32d = _three_precisions(jax, run, ref, errs)
    m_tol, k_tol = tols
    pinv_m = ("relative Frobenius; m = C' C^+ goes through the eigen-"
              "pseudo-inverse of a Gram whose condition number is ~1e16, "
              "so eigenvalues at the cutoff differ by device; the limit "
              "sits above the device's reading and the CPU Toeplitz-vs-"
              "pairwise one (cpu_err)")
    pinv_k = ("Frobenius error relative to ||C''||: K = C'' + m 'C cancels "
              "to 1.5e-4 (N_I=161) and 1.6e-5 (N_I=1025) of ||C''||, so "
              "its own relative error is that cancellation times the "
              "pseudo-inverse noise (printed as K_rel_own); the limit sits "
              "above the device's reading and the CPU one (cpu_err)")
    rec = {
        "op": "ops.kernels.magi_kernel_matrices (Toeplitz) vs pairwise "
              "build (CPU f64)", "width": n_i,
        "f64_C": check(f"C f64 N{n_i}", e64[0], 1e-12,
                       "max-abs relative; same Bessel values gathered vs "
                       "recomputed, a few ulp", failures),
        "f64_m": {**check(f"m f64 N{n_i}", e64[1], m_tol, pinv_m, failures),
                  "cpu_err": _num(e_cpu[1])},
        "f64_K": {**check(f"K f64 N{n_i}", e64[2], k_tol, pinv_k, failures),
                  "cpu_err": _num(e_cpu[2])},
        "f64_K_rel_own": _num(e64[3]),
        "f32_highest_C": check(f"C f32 N{n_i}", e32[0], 1e-5,
                               "max-abs relative; f32 Bessel ladder error",
                               failures),
        "f32_highest_m_K": {
            "err": [_num(e32[1]), _num(e32[2])],
            "note": "not gated: setup builds m and K in f64 by design "
                    "(config.setup_on_cpu); an f32 pseudo-inverse of this "
                    "Gram is ill-posed"},
        "f32_default_tf32": {"err": [_num(e) for e in e32d]},
    }
    if time_ops:
        with jax.enable_x64(True):
            rec["device_ms_f64"] = device_time_ms(
                jax, toe, (jnp.asarray(I), jnp.asarray(phi1),
                           jnp.asarray(phi2)))
    return rec


def _seir_points(model, n_points: int, seed: int = 0):
    """(X, sigma_pre, theta_pre) test points: the anchor (Xhat_init,
    thetas_init) first, then posterior-scale perturbations of it."""
    rng = np.random.default_rng(seed)
    sig = _pre(model.sigma_sqs_init, sigma_lb(model))
    th0 = _pre(model.thetas_init, np.zeros(model.D_thetas))
    pts = [(model.Xhat_init, sig, th0)]
    for _ in range(n_points):
        pts.append((
            model.Xhat_init + 0.002 * rng.standard_normal(
                model.Xhat_init.shape),
            sig,
            th0 + 0.05 * rng.standard_normal(th0.shape),
        ))
    return pts


def _numpy_log_posterior():
    """The NumPy transliteration of the reference log posterior, from the
    repository's tests (the plain reference, independent of the package)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_posterior import numpy_log_posterior

    return numpy_log_posterior


def parity_log_posterior(jax, model, failures, n_chains: int = 256,
                         time_ops: bool = True):
    """The fused log posterior on the SEIR operators against the NumPy
    transliteration of the reference formula (tests/test_posterior.py)."""
    import jax.numpy as jnp

    from magi_v2_tpu.ops.linalg import sym_sqrt
    from magi_v2_tpu.posterior import (
        log_posterior_given_t1, make_posterior_data, make_ref_point,
        make_value_and_grad,
    )

    numpy_log_posterior = _numpy_log_posterior()
    f_vec, oi = model.f_vec, model.obs_index
    C, m, K = model.C_d_invs, model.m_ds, model.K_d_invs
    lb = sigma_lb(model)
    pts = _seir_points(model, 4)
    cpu = jax.devices("cpu")[0]

    def np_lp(X, s, t):
        I = jnp.asarray(model.I)
        return numpy_log_posterior(
            X, s, t, 1.0, C, m, K, model.mu_ds, model.beta, oi.N_ds,
            oi.not_nan_idxs, oi.not_nan_cols, oi.y_observed, lb,
            lambda Xv, tv: np.asarray(f_vec(I, jnp.asarray(Xv),
                                            jnp.asarray(tv))),
        )

    with jax.enable_x64(True):
        with jax.default_device(cpu):
            ref_lp = np.array([np_lp(*p) for p in pts])

        def vag64():
            data = make_posterior_data(model.I, C, m, K, model.mu_ds,
                                       model.beta, oi, lb, jnp.float64)
            return jax.jit(make_value_and_grad(data, f_vec))

        def eval_all(vag):
            out = [vag(jnp.asarray(X), jnp.asarray(s), jnp.asarray(t),
                       jnp.asarray(1.0)) for X, s, t in pts]
            vals = np.array([float(v) for v, _ in out])
            grads = [np.concatenate([np.ravel(np.asarray(g)) for g in gs])
                     for _, gs in out]
            return vals, np.stack(grads)

        v64, g64 = eval_all(vag64())
        with jax.default_device(cpu):
            v64_cpu, g64_cpu = eval_all(vag64())
            R64 = np.asarray(sym_sqrt(jnp.asarray(C)))
            S64 = np.asarray(sym_sqrt(jnp.asarray(K)))
            ref_pt = make_ref_point(model.I, model.Xhat_init, model.mu_ds,
                                    model.thetas_init, f_vec, R64, S64, m,
                                    jnp.float64)

    def rel_vag(dt):
        """Value+grad in the relative-energy form the sampler evaluates
        (posterior.RefPoint), at the sampling dtype."""
        data = make_posterior_data(model.I, C, m, K, model.mu_ds,
                                   model.beta, oi, lb, dt,
                                   C_inv_sqrts=R64, K_inv_sqrts=S64)
        ref = ref_pt._replace(**{k: jnp.asarray(np.asarray(v), dt)
                                 for k, v in ref_pt._asdict().items()})

        def lp(X, s, t):
            delta = X - ref.x0
            Rd = jnp.einsum("dnm,dm->dn", data.C_inv_sqrts, delta.T)
            t1 = jnp.sum(Rd * (Rd + 2.0 * ref.a0))
            return log_posterior_given_t1(data, f_vec, X, s, t,
                                          jnp.asarray(1.0, dt), t1,
                                          ref=ref, delta=delta)

        return jax.value_and_grad(lp, argnums=(0, 1, 2))

    # The sampler's shape: n_chains vmapped chains, the anchor first. The
    # reference is the f64 function above, on the CPU backend, which the
    # five-point check ties to the NumPy transliteration.
    bpts = _seir_points(model, n_chains - 1, seed=1)
    stacked = lambda dt: [jnp.asarray(np.stack([p[k] for p in bpts]), dt)
                          for k in range(3)]
    flat = lambda gs: np.concatenate(
        [np.asarray(g, np.float64).reshape(len(bpts), -1) for g in gs], 1)
    with jax.enable_x64(True), jax.default_device(cpu):
        bv, bg = jax.jit(jax.vmap(vag64(), (0, 0, 0, None)))(
            *stacked(jnp.float64), jnp.asarray(1.0))
        bv_ref, bg_ref = np.asarray(bv), flat(bg)
    d_ref = bv_ref[1:] - bv_ref[0]
    batched = jax.jit(jax.vmap(rel_vag(jnp.float32)))
    args32 = stacked(jnp.float32)

    def errs32():
        v, gs = batched(*args32)
        d = np.asarray(v, np.float64)
        d = d[1:] - d[0]
        g = flat(gs)
        dlp = float(np.max(np.abs(d - d_ref)) / np.max(np.abs(d_ref)))
        gr = float(np.max(np.linalg.norm(g - bg_ref, axis=1)
                          / np.linalg.norm(bg_ref, axis=1)))
        return dlp, gr

    with jax.default_matmul_precision("highest"):
        e32 = errs32()
    with jax.default_matmul_precision("default"):
        e32d = errs32()
    g_rel64 = max(float(np.linalg.norm(g64[k] - g64_cpu[k])
                        / np.linalg.norm(g64_cpu[k])) for k in range(len(pts)))
    rec = {
        "op": "posterior.log_posterior value+grad, SEIR operators",
        "width": f"N_I={model.mag_I}, D={model.D}; f32 at {n_chains} "
                 "vmapped chains",
        "reference": "tests/test_posterior.py numpy_log_posterior (f64 "
                     "value, 5 points); the same jitted function on the CPU "
                     "backend in f64 (f64 gradient; f32 value and gradient "
                     "at every chain)",
        "f64_value": check("lp f64", rel_max(v64, ref_lp), 1e-9,
                           "relative to |lp|; the plain x'Ax form sums "
                           "terms ~1e4x |lp| in f64", failures),
        "f64_grad_vs_cpu": check("grad f64", g_rel64, 1e-9,
                                 "relative to the gradient norm; "
                                 "reduction order differs by device",
                                 failures),
        "f32_highest_dlp": check(
            "dlp f32", e32[0], 1e-4,
            "lp(x) - lp(anchor) over the chains, relative to its largest "
            "|value|, from the relative-energy form (posterior.RefPoint)",
            failures),
        "f32_highest_grad": check(
            "grad f32", e32[1], 1e-3,
            "worst chain, relative to the norm of the CPU f64 gradient",
            failures),
        "f32_default_tf32": {"dlp_err": _num(e32d[0]),
                             "grad_err": _num(e32d[1])},
    }
    if time_ops:
        with jax.default_matmul_precision("highest"):
            rec["device_ms_f32_highest_x%d_chains" % n_chains] = (
                device_time_ms(jax, batched, args32))
    return rec


def _banded_fixtures(n: int, d: int, b: int, n_chains: int, seed: int = 0):
    """A band of half-width b on d (n, n) operators, chain vectors, and an
    upper-banded (d*n, d*n) factor of half-width d*(b+1) — the block-banded
    shapes of the Lorenz GN mode."""
    rng = np.random.default_rng(seed)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    A = rng.standard_normal((d, n, n)) * (np.abs(i - j) <= b)[None]
    x = rng.standard_normal((n_chains, d, n))
    N, bw = d * n, d * (b + 1)
    i, j = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    U = rng.standard_normal((N, N)) * ((j > i) & (j - i <= bw)) / np.sqrt(bw)
    U[np.arange(N), np.arange(N)] = 1.0 + np.abs(rng.standard_normal(N))
    y = rng.standard_normal((n_chains, N))
    return A, x, U, y, bw


def parity_banded(jax, failures, n: int = 1025, d: int = 3, b: int = 100,
                  n_chains: int = 256, time_ops: bool = True):
    import jax.numpy as jnp
    import scipy.linalg as sla

    from magi_v2_tpu.ops.banded import (
        banded_diag_tile_inverses, banded_to_blocks, banded_to_blocks_upper,
        block_banded_matvec, block_banded_triangular_solve_upper,
        dense_to_banded,
    )

    A, x, U, y, bw = _banded_fixtures(n, d, b, n_chains)
    mv_ref = np.einsum("dnm,cdm->cdn", A, x)
    sv_ref = sla.solve_triangular(U, y.T, lower=False).T
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        A_blk = np.asarray(banded_to_blocks(dense_to_banded(A, b)))
        U_blk = np.asarray(banded_to_blocks_upper(dense_to_banded(U, bw)))
        U_dinv = np.asarray(banded_diag_tile_inverses(jnp.asarray(U_blk), d * n))
    mv = jax.jit(block_banded_matvec)
    sv = jax.jit(lambda B, y, dinv: block_banded_triangular_solve_upper(
        B, y, diag_inv=dinv))

    def run(dt):
        c = lambda a: jnp.asarray(a, dt)
        return (np.asarray(mv(c(A_blk), c(x)), np.float64),
                np.asarray(sv(c(U_blk), c(y), c(U_dinv)), np.float64))

    errs = lambda out, _: (rel_max(out[0], mv_ref), rel_max(out[1], sv_ref))
    e64, e32, e32d = _three_precisions(jax, run, None, errs)
    rec = {
        "op": "ops.banded block_banded_matvec vs dense matvec; "
              "block_banded_triangular_solve_upper vs "
              "scipy.linalg.solve_triangular",
        "width": f"N_I={n}, D={d}, b={b}, {n_chains} chains; factor "
                 f"{d * n}x{d * n} half-width {bw}",
        "f64_matvec": check("matvec f64", e64[0], 1e-12,
                            "max-abs relative; sums of 2b+1 products",
                            failures),
        "f64_solve": check("solve f64", e64[1], 1e-10,
                           "max-abs relative; kappa(U) times f64 eps",
                           failures),
        "f32_highest_matvec": check("matvec f32", e32[0], 1e-5,
                                    "max-abs relative; f32 sums of ~2b+1 "
                                    "products", failures),
        "f32_highest_solve": check("solve f32", e32[1], 1e-4,
                                   "max-abs relative; kappa(U) * eps_f32 "
                                   "through the back substitution",
                                   failures),
        "f32_default_tf32": {"matvec_err": _num(e32d[0]),
                             "solve_err": _num(e32d[1])},
    }
    if time_ops:
        c = lambda a: jnp.asarray(a, jnp.float32)
        with jax.default_matmul_precision("highest"):
            rec["device_ms_f32_highest_matvec"] = device_time_ms(
                jax, mv, (c(A_blk), c(x)))
            rec["device_ms_f32_highest_solve"] = device_time_ms(
                jax, sv, (c(U_blk), c(y), c(U_dinv)))
    return rec


def phase_parity(jax, seir_model, failures, time_ops: bool = True):
    """Every op at the real widths: kv over 2^20 points, the kernel build
    at SEIR's N_I=161 and Lorenz's N_I=1025 (phi of the Lorenz fit), the
    SEIR posterior with 256 chains, and Lorenz's block-banded ops."""
    seir_phi = (float(np.mean(seir_model.phi1s)),
                float(np.mean(seir_model.phi2s)))
    jobs = [lambda: parity_bessel(jax, 1 << 20, failures, time_ops)]
    for n, t_max, (p1, p2) in ((161, 4.0, seir_phi), (1025, 2.0, (100.0, 0.2))):
        jobs.append(lambda n=n, t=t_max, p1=p1, p2=p2: parity_kernel_matrices(
            jax, n, t, p1, p2, KERNEL_F64_TOLS[n], failures, time_ops))
    jobs.append(lambda: parity_log_posterior(jax, seir_model, failures,
                                             256, time_ops))
    jobs.append(lambda: parity_banded(jax, failures, n=1025, n_chains=256,
                                      time_ops=time_ops))
    recs = []
    for job in jobs:
        t0 = time.time()
        rec = job()
        rec["wall_s"] = time.time() - t0
        recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# phase 2: SEIR through the public API
# ---------------------------------------------------------------------------

BENCH_RECIPE = dict(
    algorithm="hmc", hmc_num_leapfrogs=192, mass_matrix="dense",
    anneal_mode="reference", dense_shrinkage=0.2, init_jitter=0.01,
    mass_window=(0.25, 0.45), mass_window2=(0.50, 0.72),
    mass_window1_diag=True,
)


def _theta_summary(res, wall):
    from magi_v2_tpu.utils import summarize_chains

    th = res["thetas_samps"]
    s = summarize_chains(th, wall)
    return {
        "theta_mean": th.mean(axis=(0, 1)).tolist(),
        "rhat_max": s["rhat_max"], "ess_min": s["ess_min"],
        "divergence_rate": float(res["kernel_results"]["divergences"].mean()),
        "step_size": float(res["kernel_results"]["step_size"]),
    }


def phase_seir(jax, model, setup_s, failures, num_chains: int = 256,
               steps: int = 1000, nuts_chains: int = 64,
               nuts_steps: int = 300, warm_rerun: bool = True):
    """The benchmark recipe (run 1, f32), predict()'s defaults (run 2,
    NUTS f64 with the progress callback) and map_estimate() (run 3)."""
    import copy

    from magi_v2_tpu import MagiConfig

    truth = np.array(SEIR_THETA)
    out = {"setup_s": setup_s, "N_I": model.mag_I}

    # run 1: the benchmark recipe (bench.py), f32
    t0 = time.time()
    res = model.predict(num_results=steps, num_burnin_steps=steps,
                        num_chains=num_chains, seed=0, **BENCH_RECIPE)
    first_wall = time.time() - t0
    run1 = _theta_summary(res, first_wall)
    run1["first_call_wall_s"] = first_wall
    # predict() samples on JAX's default device, which require_gpu has
    # checked is the GPU
    run1["sampler_device"] = str(jax.devices()[0])
    run1["peak_bytes_in_use"] = peak_bytes(jax)
    rel = np.abs(np.array(run1["theta_mean"]) / truth - 1.0)
    run1["theta_rel_err"] = rel.tolist()
    if not np.all(rel <= 0.10):
        failures.append(f"seir bench recipe theta off truth: {rel}")
    if not run1["rhat_max"] <= 1.05:
        failures.append(f"seir bench recipe rhat {run1['rhat_max']}")
    if warm_rerun:
        t0 = time.time()
        model.predict(num_results=steps, num_burnin_steps=steps,
                      num_chains=num_chains, seed=1, **BENCH_RECIPE)
        run1["warm_wall_s"] = time.time() - t0
        run1["compile_s_estimate"] = first_wall - run1["warm_wall_s"]
    out["run1_bench_recipe_f32"] = run1

    # run 2: predict()'s defaults (NUTS, diagonal metric) in f64 with the
    # host progress callback
    model64 = copy.copy(model)
    model64.config = MagiConfig()
    buf = io.StringIO()
    with jax.enable_x64(True), contextlib.redirect_stdout(buf):
        t0 = time.time()
        res2 = model64.predict(num_results=nuts_steps,
                               num_burnin_steps=nuts_steps,
                               num_chains=nuts_chains, seed=2, verbose=True)
        wall2 = time.time() - t0
        jax.effects_barrier()
    run2 = _theta_summary(res2, wall2)
    run2["wall_s"] = wall2
    run2["progress_lines"] = buf.getvalue().count("[sampler]")
    if not run2["progress_lines"]:
        failures.append("no progress callback output from predict(verbose)")
    if not np.all(np.isfinite(res2["X_samps"])):
        failures.append("non-finite NUTS f64 draws")
    out["run2_nuts_f64_defaults"] = run2

    # run 3: map_estimate() with the GPU as default backend
    t0 = time.time()
    mp = model.map_estimate()
    run3 = {"wall_s": time.time() - t0,
            "theta_map": np.asarray(mp["theta_map"]).tolist(),
            "converged": bool(mp["converged"]),
            "grad_norm": float(mp["grad_norm"])}
    if not np.all(np.isfinite(mp["theta_map"])):
        failures.append("non-finite MAP")
    out["run3_map_estimate"] = run3
    return out


# ---------------------------------------------------------------------------
# phase 3: f64 setup on the GPU
# ---------------------------------------------------------------------------

# Three H100 runs read 4.6e-6, 9.3e-6 and 1.6e-5 (theta_init, the largest):
# the GPU's reduction order is not fixed from run to run.
SETUP_RTOL = 1e-4


def phase_gpu_setup(jax, cpu_model, failures, n_obs: int = 81):
    import jax.numpy as jnp

    with jax.enable_x64(True):
        gpu_model, setup_s = fit_seir(jnp.float64, n_obs, setup_on_cpu=False)
    out = {"setup_s": setup_s, "rtol": SETUP_RTOL,
           "reason": "1000 Adam steps (hyperparameters) and 10000 (theta) "
                     "amplify reduction-order differences between "
                     "devices; earlier H100 readings 4.6e-6 to 1.6e-5, and "
                     "1e-4 is far below theta's posterior sd"}
    for name in ("phi1s", "phi2s", "sigma_sqs_init", "thetas_init"):
        a = np.asarray(getattr(gpu_model, name))
        b = np.asarray(getattr(cpu_model, name))
        err = float(np.max(np.abs(a - b) / np.abs(b)))
        out[name] = {"gpu": a.tolist(), "cpu": b.tolist(), "rel_err": err}
        if not np.all(np.isfinite(a)):
            failures.append(f"GPU f64 setup gave non-finite {name}")
        elif err > SETUP_RTOL:
            failures.append(f"GPU f64 setup {name} rel err {err:.2e}")
    return out


# ---------------------------------------------------------------------------
# phase 4: dense grid
# ---------------------------------------------------------------------------

HYBRID_F64_RTOL = 1e-9
HYBRID_F32_RTOL = 1e-3


def phase_dense_grid(jax, failures, n_obs: int = 257, disc: int = 2,
                     bandsize: int = 100, num_chains: int = 128,
                     burnin: int = 300, results: int = 200,
                     leapfrogs: int = 64):
    import jax.numpy as jnp

    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu.models import lorenz_f_vec
    from magi_v2_tpu.sampler.magi_state import (
        flatten_state, make_tempered_logp_grad,
    )

    ts, X, _ = lorenz_data(n_obs)
    model = MAGI_v2(
        D_thetas=3, ts_obs=ts, X_obs=X, bandsize=bandsize,
        f_vec=lorenz_f_vec,
        config=MagiConfig().replace(dtype=jnp.float32, anneal_min_temp=0.3),
    )
    t0 = time.time()
    model.initial_fit(discretization=disc)
    out = {"N_I": model.mag_I, "setup_s": time.time() - t0}
    t0 = time.time()
    res = model.predict(
        num_results=results, num_burnin_steps=burnin, num_chains=num_chains,
        seed=0, init_jitter=0.05, storage="hybrid", reparam="precond",
        mass_matrix="auto", algorithm="hmc", hmc_num_leapfrogs=leapfrogs,
        anneal_mode="reference",
    )
    out["predict_wall_s"] = time.time() - t0
    out.update(_theta_summary(res, out["predict_wall_s"]))
    out["peak_bytes_in_use"] = peak_bytes(jax)
    finite = all(np.all(np.isfinite(res[k]))
                 for k in ("X_samps", "thetas_samps", "sigma_sqs_samps"))
    out["draws_finite"] = bool(finite)
    if not finite:
        failures.append("non-finite dense-grid draws")

    # The hybrid log density is the posterior through the exact operators
    # in their f64 square-root factors R, S (R'R = C^-1, S'S = K^-1),
    # evaluated in GN-whitened coordinates relative to an anchor: equal up
    # to a constant, so compare lp(draw) - lp(spline init). The reference
    # is the NumPy transliteration of tests/test_posterior.py through the
    # same R, S (sums of squares). Through C^-1, K^-1 themselves (x'Ax) it
    # is no reference at this grid: the sum cancels terms far larger than
    # lp, and its error reached thousands of nats even in f64.
    numpy_log_posterior = _numpy_log_posterior()
    lb = sigma_lb(model)
    X1 = res["X_samps"][-1, 0]
    s1 = _pre(res["sigma_sqs_samps"][-1, 0], lb)
    t1 = _pre(res["thetas_samps"][-1, 0], np.zeros(3))
    pts = [(model.Xhat_init, s1, t1), (X1, s1, t1)]

    def hybrid_dlp(dtype):
        mode, data = model._build_sampling_setup("precond", "hybrid",
                                                 dtype)[:2]
        lp_fn, one = jax.jit(mode.logp_grad), jnp.asarray(1.0, dtype)
        lp = [float(lp_fn(jnp.asarray(np.concatenate(
            [np.ravel(mode.whiten64(Xp)), s, t]), dtype), one)[0])
            for Xp, s, t in pts]
        return lp[1] - lp[0], data

    with jax.enable_x64(True):
        d_h64, data64 = hybrid_dlp(jnp.float64)
        # the centered dense posterior on the same operators
        # (reparam='centered', storage='dense'): the package's own route
        lp_c_fn = jax.jit(make_tempered_logp_grad(
            data64, lorenz_f_vec, model.mag_I, model.D, model.D_thetas))
        lp_c = [float(lp_c_fn(flatten_state(jnp.asarray(Xp), jnp.asarray(s),
                                            jnp.asarray(t)),
                              jnp.asarray(1.0))[0]) for Xp, s, t in pts]
        dn = {k: np.asarray(v) for k, v in data64._asdict().items()}
        I = jnp.asarray(dn["I"])
        lp_np = [numpy_log_posterior(
            np.asarray(Xp, np.float64), s, t, 1.0, None, dn["m_ds"], None,
            dn["mu_ds"], dn["beta"], dn["N_ds"], dn["not_nan_idxs"],
            dn["not_nan_cols"], dn["y_observed"], dn["sigma_sqs_LB"],
            lambda Xv, tv: np.asarray(lorenz_f_vec(I, jnp.asarray(Xv),
                                                   jnp.asarray(tv))),
            C_inv_sqrts=dn["C_inv_sqrts"], K_inv_sqrts=dn["K_inv_sqrts"],
        ) for Xp, s, t in pts]
    with jax.default_matmul_precision("highest"):
        d_h32 = hybrid_dlp(jnp.float32)[0]
    d_np, d_c = lp_np[1] - lp_np[0], lp_c[1] - lp_c[0]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1.0)
    out["hybrid_f64_vs_numpy"] = check(
        "hybrid dlp f64", rel(d_h64, d_np), HYBRID_F64_RTOL,
        "lp(draw) - lp(spline init), f64 hybrid vs the NumPy "
        "transliteration through R, S, relative to max(|difference|, "
        "1 nat); f64 sums of squares of ~1e7 nats", failures)
    out["hybrid_f64_vs_centered"] = check(
        "hybrid vs centered dlp f64", rel(d_h64, d_c), HYBRID_F64_RTOL,
        "the same difference from the centered dense posterior; only the "
        "whitening round trip and the relative-energy bookkeeping differ",
        failures)
    out["hybrid_f32_vs_f64"] = check(
        "hybrid dlp f32", rel(d_h32, d_h64), HYBRID_F32_RTOL,
        "the same difference from the f32 hybrid the sampler ran against "
        "the f64 one; relative-energy f32 noise grows with the distance "
        "from the anchor (CPU: <= 2e-5 at N_I=1025)", failures)
    out["dlp"] = {"hybrid_f32": d_h32, "hybrid_f64": d_h64,
                  "numpy_f64": d_np, "centered_f64": d_c}
    return out


# ---------------------------------------------------------------------------
# phase 5: four GPUs
# ---------------------------------------------------------------------------

def _seir_chain_inputs(model, dtype, num_chains, seed=0):
    """(logp_grad, q0) of the SEIR precond/dense mode, as predict() builds
    them, with init_jitter 0.01 on the trajectory block."""
    import jax.numpy as jnp

    from magi_v2_tpu.sampler.magi_state import flatten_state

    mode, _, lb, _, _ = model._build_sampling_setup("precond", "dense", dtype)
    q0 = np.asarray(flatten_state(
        mode.X0, jnp.asarray(_pre(model.sigma_sqs_init, lb), dtype),
        jnp.asarray(_pre(model.thetas_init, np.zeros(3)), dtype)))
    q0 = np.broadcast_to(q0, (num_chains, q0.shape[0])).copy()
    nd = model.mag_I * model.D
    q0[1:, :nd] += 0.01 * np.random.default_rng(seed).standard_normal(
        (num_chains - 1, nd))
    return mode.logp_grad, jnp.asarray(q0, dtype)


def _collective_ms(jax, fn):
    """Device time of collective ops (all-reduce / NCCL kernels) in one
    warm call of ``fn``, summed over the GPUs, from a profiler trace."""
    total, names = 0, set()
    for name, lo, hi in gpu_trace_events(jax, fn, 1):
        n = name.lower()
        if "all-reduce" in n or "allreduce" in n or "nccl" in n:
            total += hi - lo
            names.add(name[:60])
    return total / 1e6, sorted(names)[:8]


def phase_four_gpus(jax, failures, n_dev: int = 4, num_chains: int = 1024,
                    steps: int = 1000, n_obs: int = 81):
    import jax.numpy as jnp

    from magi_v2_tpu.parallel import chain_mesh, run_nuts_chains_sharded
    from magi_v2_tpu.sampler import SamplerConfig, run_nuts_chains
    from magi_v2_tpu.posterior import softplus
    from magi_v2_tpu.utils import effective_sample_size, summarize_chains

    devs = jax.devices()[:n_dev]
    mesh = chain_mesh(devs)
    model, setup_s = fit_seir(jnp.float32, n_obs)
    dim = model.mag_I * model.D + model.D + model.D_thetas
    out = {"devices": n_dev, "chains": num_chains, "setup_s": setup_s}

    def cfg(n, **kw):
        return SamplerConfig(
            num_results=n, num_burnin_steps=n, algorithm="hmc",
            hmc_num_leapfrogs=192, dense_tail_size=dim, anneal_mode="reference",
            **kw)

    def one_card(lg, q0, key, c):
        with jax.default_device(devs[0]):
            return run_nuts_chains(lg, jax.device_put(q0, devs[0]), key, c)

    # f64, 4+4 steps: sharded vs one card draw for draw (the default mass
    # window [1, 2) pools the dense Welford covariance across devices)
    with jax.enable_x64(True):
        lg, q0 = _seir_chain_inputs(model, jnp.float64, num_chains)
        key = jax.random.PRNGKey(0)
        c4 = cfg(4, dense_shrinkage=0.2)
        s_sh, _ = run_nuts_chains_sharded(lg, q0, key, c4, mesh=mesh)
        s_sh = np.asarray(jax.block_until_ready(s_sh))
        s_one, _ = one_card(lg, q0, key, c4)
        s_one = np.asarray(s_one)
    diff = np.max(np.abs(s_sh - s_one), axis=(0, 2))    # per chain
    scale = np.max(np.abs(s_one))
    frac = float(np.mean(diff <= 1e-6 * scale))
    out["f64_4x4"] = {
        "max_abs_diff": float(diff.max()), "median_abs_diff":
        float(np.median(diff)), "frac_chains_within_1e-6": frac,
        "tol": "max|diff| <= 1e-6 * max|draw| for >= 99% of chains",
        "reason": "cross-device all-reduces reorder the pooled sums, so "
                  "step size and metric differ in the last bits; an "
                  "accept decision at the threshold may flip for a chain",
    }
    if frac < 0.99:
        failures.append(f"sharded f64 draws differ: {frac:.3f} within tol")
    # a warm repeat of the same sharded call (no new compilation)
    with jax.enable_x64(True):
        run = lambda: run_nuts_chains_sharded(lg, q0, key, c4, mesh=mesh)[0]
        t0 = time.time()
        jax.block_until_ready(run())
        wall = time.time() - t0
        coll_ms, names = _collective_ms(jax, run)
    out["collectives_f64_4x4"] = {"wall_s": wall,
                                  "collective_device_ms": coll_ms,
                                  "collective_ops": names}

    # f32, 1000+1000: theta means agree within Monte Carlo error
    lg, q0 = _seir_chain_inputs(model, jnp.float32, num_chains)
    key = jax.random.PRNGKey(1)
    recipe = dict(dense_shrinkage=0.2, mass_window_begin=0.25,
                  mass_window_end=0.45, mass_window2_begin=0.50,
                  mass_window2_end=0.72, mass_window1_diag=True)
    res = {}
    with jax.default_matmul_precision("highest"):
        for name, fn in (
            ("sharded", lambda: run_nuts_chains_sharded(
                lg, q0, key, cfg(steps, **recipe), mesh=mesh)),
            ("one_card", lambda: one_card(lg, q0, key, cfg(steps, **recipe))),
        ):
            t0 = time.time()
            s, _ = fn()
            s = np.asarray(jax.block_until_ready(s))
            wall = time.time() - t0
            th = np.asarray(softplus(jnp.asarray(s[..., -model.D_thetas:])))
            summ = summarize_chains(th, wall)
            ess = np.array([effective_sample_size(th[:, :, p])
                            for p in range(th.shape[-1])])
            res[name] = {"wall_s": wall, "theta_mean":
                         th.mean(axis=(0, 1)).tolist(),
                         "theta_se": (th.std(axis=(0, 1))
                                      / np.sqrt(ess)).tolist(),
                         "rhat_max": summ["rhat_max"],
                         "ess_min": summ["ess_min"]}
    m_s, m_1 = (np.array(res[k]["theta_mean"]) for k in ("sharded",
                                                            "one_card"))
    se = np.sqrt(np.array(res["sharded"]["theta_se"]) ** 2
                 + np.array(res["one_card"]["theta_se"]) ** 2)
    z = np.abs(m_s - m_1) / se
    res["z_max"] = float(z.max())
    res["tol"] = "|mean_sharded - mean_one| <= 4 * combined MC standard error"
    if not np.all(z <= 4.0):
        failures.append(f"sharded f32 theta means off by z={z}")
    out["f32_1000x1000"] = res

    return out


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only phase 5: chain sharding over four GPUs "
                         "against one")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from magi_v2_tpu.utils.compile_cache import enable_compile_cache

    # phase 0: device
    cache_dir = enable_compile_cache()
    devs = require_gpu(jax, 4 if args.four_gpus else 1)
    card = card_name_and_power()
    kind = devs[0].device_kind
    emit("0_device", card, platform=devs[0].platform, device_kind=kind,
         device_count=len(devs), jax=jax.__version__,
         compile_cache=cache_dir,
         jax_platforms=os.environ.get("JAX_PLATFORMS", ""))
    failures: list[str] = []

    def run_phase(name, fn):
        t0 = time.time()
        n_fail = len(failures)
        try:
            rec = fn()
        except Exception as e:
            # a phase boundary: record the failure, run the other phases,
            # and exit non-zero without the result line
            traceback.print_exc()
            failures.append(f"{name}: {type(e).__name__}: {e}")
            rec = {"error": f"{type(e).__name__}: {e}"}
        emit(name, card, ok=len(failures) == n_fail,
             phase_wall_s=time.time() - t0, result=rec,
             failures=failures[n_fail:])

    if args.four_gpus:
        run_phase("5_four_gpus", lambda: phase_four_gpus(jax, failures))
    else:
        seir, setup_s = fit_seir(jnp.float32)
        run_phase("1_parity", lambda: phase_parity(jax, seir, failures))
        run_phase("2_seir", lambda: phase_seir(jax, seir, setup_s, failures))
        run_phase("3_gpu_setup_f64",
                  lambda: phase_gpu_setup(jax, seir, failures))
        run_phase("4_dense_grid", lambda: phase_dense_grid(jax, failures))
    if failures:
        print(f"chip_smoke FAILED: {failures}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": kind, "count": len(devs)}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
