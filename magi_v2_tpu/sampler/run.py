"""Multi-chain annealed-NUTS driver: warmup (dual-averaging step size +
pooled diagonal mass matrix) and sampling, each as one lax.scan in one jit.

Replaces the reference's predict() sampling stack (magi_v2.py:360-396):
tfp.mcmc.sample_chain + DualAveragingStepSizeAdaptation + the
LogAnnealedNUTS wrapper. Key differences, all for one-jit accelerator
execution:

- The annealing step counter is part of the scan carry (traced), not a
  Python-side tf.Variable — fixing the crash class recorded in the
  reference's committed notebooks (SURVEY.md §4).
- Chains are vmapped; the step size is shared across chains and adapted
  from the pooled mean acceptance (with one chain this reduces to the
  reference's setup; with many it is the standard cross-chain variant).
- Mass-matrix warmup (off in the reference — identity mass) pools moments
  across chains *and* steps in a Welford window, so 256 chains give a good
  diagonal estimate quickly. Disable via adapt_mass_matrix=False for
  closest reference parity.
- Dual averaging follows Stan/TFP semantics: mu = log(10*eps0),
  gamma=0.05, t0=10, kappa=0.75, target_accept=0.75 (magi_v2.py:364-366),
  adapting for adaptation_fraction * num_burnin steps (magi_v2.py:365).
"""

from __future__ import annotations

import os
import time
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from magi_v2_tpu.sampler.mass import (
    identity_mass,
    mass_diag,
    mass_from_moments,
    mass_kinetic,
    mass_sample_momentum,
    mass_tail_inv,
    mass_vel,
)
from magi_v2_tpu.sampler.nuts import NutsConfig, nuts_step


def log_temperature_schedule(step, min_temp=0.1):
    """beta_temp(step) = max(1/log(step+2), min_temp) — reference
    logarithmic_temperature_schedule (magi_v2.py:833-835)."""
    step = jnp.asarray(step, jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    return jnp.maximum(1.0 / jnp.log(step + 2.0), min_temp)


class SamplerConfig(NamedTuple):
    num_results: int = 1000
    num_burnin_steps: int = 1000
    initial_step_size: float = 0.1     # magi_v2.py:364
    target_accept: float = 0.75        # magi_v2.py:366
    adaptation_fraction: float = 0.8   # magi_v2.py:365
    max_tree_depth: int = 10
    max_energy_diff: float = 1000.0
    anneal_min_temp: float = 0.1       # magi_v2.py:841
    use_annealing: bool = True
    # "reference": the reference's schedule runs through sampling too, so
    # results are draws from a TEMPERED posterior at temp ~1/log(steps)
    # (~0.13 at 2000 steps — this is what the reference's published numbers
    # are, magi_v2.py:348,833-835). "warmup_only": anneal during warmup,
    # sample the true posterior (temp=1) afterwards.
    anneal_mode: str = "reference"
    adapt_mass_matrix: bool = True
    # Mass-adaptation window (fractions of burnin). In "warmup_only" mode
    # the temperature ramp ends at mass_window_begin so Welford measures
    # the beta=1 posterior — measuring the FLATTENED posterior and then
    # sampling at beta=1 leaves the mass ~1/beta too large per coordinate
    # (measured Lorenz N_I=1025 x 256 chains: inv_mass median 33, max
    # 3.5e3 where the GN-whitened scale is ~1; dual averaging then slashes
    # eps to 1.1e-4 to accommodate the overscaled directions and every
    # chain freezes). Window placed late so the pre-window dispersal
    # transient (mean drift inflates Welford variance) has settled.
    mass_window_begin: float = 0.45
    mass_window_end: float = 0.7
    # Optional SECOND Welford window (fractions of burnin; end <= begin
    # disables — the default). Stan-style staged adaptation: the first
    # window's metric is applied at mass_window_end, the chains re-mix
    # under it, and a fresh estimate over [begin2, end2) REPLACES it
    # (accumulators reset at each apply; dual averaging restarts around
    # the current step size after each window, so end2 must leave room
    # before adaptation_fraction * burnin for the final eps adaptation).
    # Motivation (measured, results/seir_seed_sweep.json): the TEMPERED
    # single-window warmup is seed-fragile at long trajectories — on
    # seeds 4/8 the [0.45, 0.7) window's covariance estimate is degraded
    # by slow pre-metric mixing and ESS_min lands 5-7x below typical
    # even under 20% shrinkage. A second window measures a chain that
    # already mixes under the first window's metric, breaking the
    # bad-metric -> bad-estimate feedback.
    mass_window2_begin: float = 0.0
    mass_window2_end: float = 0.0
    # With two windows and a dense tail block: apply only the DIAGONAL
    # (per-coordinate scales) at the first window's close, deferring the
    # dense correlations to window 2 (Stan-like robust staging). A noisy
    # first-window correlation estimate degrades the very mixing window 2
    # measures — the 10-seed sweep's residual tail (seed 9: ESS_min 6.2k
    # vs 114k-129k typical under dense-first two-window).
    mass_window1_diag: bool = False
    # Dense inverse-mass block over the LAST k flat-state coordinates (the
    # (sigma_pre, theta_pre) tail; 0 = fully diagonal, the default). A
    # diagonal cannot rotate the correlated theta ridge that forces long
    # HMC trajectories; the k x k dense block (Stan's dense metric,
    # estimated in the same Welford window with the same shrinkage) whitens
    # it at negligible per-leapfrog cost. See sampler/mass.py.
    dense_tail_size: int = 0
    # Shrink the dense block's estimated CORRELATIONS toward the diagonal:
    # cov <- (1-s)*cov + s*diag(cov) (marginal scales untouched). 0.0
    # (default) keeps the raw Stan-regularized estimate. Motivation: the
    # TEMPERED (anneal_mode='reference') warmup is seed-fragile at long
    # trajectories — on some seeds the annealed Welford window yields a
    # degraded covariance and ESS_min drops 5-16x (measured on the SEIR
    # bench at L=160/192, results/seir_tempered_shrink_probe.json); partial
    # shrinkage trades whitening quality for robustness to that
    # misestimation.
    dense_shrinkage: float = 0.0
    # Host progress line every k steps via jax.debug.callback (0 = off) —
    # the in-graph replacement for the reference's tqdm (unusable under
    # XLA, magi_v2.py:285).
    progress_every: int = 0
    # Keep every thin-th draw: num_results draws are RETURNED, each
    # separated by thin transitions (num_results * thin total post-warmup
    # transitions; only the stored draws' stats are returned).
    thin: int = 1
    # Split the run into multiple device dispatches of at most this many
    # steps (0 = single dispatch). Blocks are the checkpoint granularity
    # (checkpoint_path), and above stage_above_bytes they stream samples
    # to host, bounding device memory. State is carried across blocks, so
    # results are bit-identical to the single-dispatch path.
    dispatch_block_steps: int = 0
    # Transition kernel: "nuts" (adaptive trajectory lengths) or "hmc"
    # (fixed jittered length, all chains in lockstep — no slowest-tree
    # sync under vmap, the throughput mode; see sampler/hmc.py).
    algorithm: str = "nuts"
    hmc_num_leapfrogs: int = 64    # max leapfrogs per HMC step
    hmc_jitter: bool = True        # jitter length per step (shared by chains)
    # f32 matmul precision: "highest" (full f32) or a reduced setting.
    # On the GPU "default" lets XLA run f32 matmuls in TF32 (10-bit
    # mantissa) — see run_nuts_chains docstring.
    matmul_precision: str = "highest"
    # Parallel tempering (replica exchange) over the SAMPLING phase: a
    # strictly-decreasing ladder starting at 1.0, e.g. (1.0, 0.7, 0.5,
    # 0.35); () disables. num_chains must divide by the ladder length R:
    # chains are rung-major — chains [r*M, (r+1)*M) run at beta=pt_betas[r]
    # (M = C/R) and every pt_swap_every transitions adjacent rungs propose
    # state exchanges (even-odd alternation; exact Metropolis rule — the
    # target at beta is lp_beta = beta * lp, posterior.py:374, so
    # log alpha = (beta_i - beta_j) * (lp(q_j) - lp(q_i))). WARMUP runs
    # entirely at beta=1 for all chains (adaptation measures the real
    # target); during sampling each rung's step size is eps * beta^-1/2
    # (the tempered curvature scales ~beta: whitened lam_max measured
    # exactly proportional between beta 0.3 and 1.0,
    # results/map_anchor_probe_1025.json). Only the beta=1 rung's draws
    # are the posterior sample — the caller (api.predict) slices chains
    # [0, M). The hot rungs cross energy barriers the cold chains cannot
    # (the Hes1 unobserved-H posterior's coupled/decoupled modes,
    # DEVIATIONS #23); swaps propagate those crossings down the ladder.
    # Incompatible with anneal_mode='reference' (sampling must target a
    # fixed beta=1 posterior for the ladder to be exact).
    pt_betas: tuple = ()
    pt_swap_every: int = 1
    # Directory for mid-run checkpoint/resume ("" = off). Requires
    # dispatch blocking conceptually but works regardless: at every block
    # boundary the carry is written atomically to <dir>/state.npz and each
    # completed sampling block's draws to <dir>/draws_*.npz, so a crash —
    # including one during the post-sampling result fetch — resumes
    # bit-identically by re-calling with the same arguments. A config
    # fingerprint guards against resuming a checkpoint from a different
    # run.
    checkpoint_path: str = ""
    # Record wall-clock phase timings (eps search, warmup, sampling
    # dispatch/staging/drain) in ChainStats.timings, plus PER-BLOCK walls
    # (warmup_block_walls_s / block_walls_s) measured with a device sync
    # after every dispatch block. The syncs serialize the host thread with
    # the device queue (losing the stage/compute overlap), so profiled
    # walls are an upper bound on production walls — keep off in
    # production, on for perf attribution.
    profile_timings: bool = False
    # Under dispatch blocking, draws accumulate ON DEVICE while their
    # total size fits under this budget (bytes), and spill to host staging
    # block by block above it (or whenever checkpointing, which needs
    # host files). It bounds the device memory the draws hold beside the
    # sampler's working set. Pure-I/O knob — the draw VALUES are
    # bit-identical either way.
    stage_above_bytes: int = 1 << 30


_CKPT_VERSION = "v2"


def _ckpt_fingerprint(config: "SamplerConfig", C: int, dim: int,
                      key, q0) -> str:
    """Identity of a run for resume safety.

    Covers EVERY SamplerConfig field except the pure-I/O knobs
    (progress_every, checkpoint_path, profile_timings, stage_above_bytes
    — none touches the step or PRNG sequence), plus the chain/state
    shape, the PRNG key, and a digest of
    the initial chain states. The round-3 fingerprint listed fields by
    hand and omitted dense_shrinkage / matmul_precision / hmc_jitter /
    target_accept / adaptation_fraction / mass_window_* / max_tree_depth /
    anneal_min_temp and the seed — re-calling with any of those changed
    silently resumed the old run's step sequence. Bumping _CKPT_VERSION
    (or the format change itself) invalidates pre-round-4 checkpoints;
    that is the safe direction.
    """
    import hashlib

    ident = config._replace(progress_every=0, checkpoint_path="",
                            profile_timings=False,
                            stage_above_bytes=SamplerConfig().stage_above_bytes)
    q0_digest = hashlib.blake2b(
        np.ascontiguousarray(np.asarray(q0)).tobytes(), digest_size=8
    ).hexdigest()
    key_hex = np.ascontiguousarray(np.asarray(key)).tobytes().hex()
    return (
        f"{_CKPT_VERSION}/{ident!r}/C{C}/dim{dim}/"
        f"key{key_hex}/q0{q0_digest}"
    )


def _ckpt_restore_carry(template, leaves):
    """Rebuild a scan carry from checkpointed leaves, re-applying each
    template leaf's dtype AND sharding — a resumed run must come back with
    the caller's mesh layout (bare jnp.asarray left a sharded run's carry
    on the default device after resume, silently dropping SPMD)."""
    t_leaves = jax.tree.leaves(template)
    if len(t_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint carry has {len(leaves)} leaves, expected "
            f"{len(t_leaves)} — incompatible checkpoint"
        )
    out = []
    for t, x in zip(t_leaves, leaves):
        x = jnp.asarray(x)
        if isinstance(t, jax.Array):
            x = x.astype(t.dtype)
            # Re-commit only leaves the caller committed (the sharded q0;
            # scalars/keys stay uncommitted exactly as in a fresh run —
            # committing them to their single default device would clash
            # with the multi-device chain leaves inside one jit).
            if (len(t.sharding.device_set) > 1
                    or getattr(t, "_committed", False)):
                x = jax.device_put(x, t.sharding)
        out.append(x)
    return jax.tree.unflatten(jax.tree.structure(template), out)


def _ckpt_save_state(dirpath, phase, nxt, carry, fingerprint):
    """Atomically persist a block-boundary carry (phase = warmup|sample)."""
    os.makedirs(dirpath, exist_ok=True)
    # np.savez appends ".npz" to names not ending in it — keep the suffix
    tmp = os.path.join(dirpath, "state.tmp.npz")
    np.savez(
        tmp,
        _phase=np.array(phase),
        _next=np.array(nxt),
        _fingerprint=np.array(fingerprint),
        **{f"l{i}": np.asarray(x)
           for i, x in enumerate(jax.tree.leaves(carry))},
    )
    os.replace(tmp, os.path.join(dirpath, "state.npz"))


def _ckpt_load_state(dirpath, fingerprint):
    """Return (phase, next_step, leaf_list) or None if no checkpoint."""
    p = os.path.join(dirpath, "state.npz")
    if not os.path.exists(p):
        return None
    with np.load(p) as z:
        found = str(z["_fingerprint"])
        if found != fingerprint:
            raise ValueError(
                f"sampler checkpoint at {dirpath!r} is from a different "
                f"run (saved {found!r} != requested {fingerprint!r}); "
                "delete the directory or point checkpoint_path elsewhere"
            )
        n = sum(1 for k in z.files if not k.startswith("_"))
        return str(z["_phase"]), int(z["_next"]), [z[f"l{i}"] for i in range(n)]


def _ckpt_save_draws(dirpath, start, s_blk, info_dict):
    tmp = os.path.join(dirpath, f"draws_{start:06d}.tmp.npz")
    np.savez(
        tmp,
        samples=np.asarray(s_blk),
        **{f"info_{k}": np.asarray(v) for k, v in info_dict.items()},
    )
    os.replace(tmp, os.path.join(dirpath, f"draws_{start:06d}.npz"))


def _ckpt_load_draws(dirpath, start):
    p = os.path.join(dirpath, f"draws_{start:06d}.npz")
    if not os.path.exists(p):
        return None
    with np.load(p) as z:
        return z["samples"], {
            k[len("info_"):]: z[k] for k in z.files if k.startswith("info_")
        }


class _DAState(NamedTuple):
    log_step: jax.Array
    log_step_avg: jax.Array
    h_bar: jax.Array
    mu: jax.Array
    count: jax.Array


def _da_init(step_size, dtype):
    eps = jnp.asarray(step_size, dtype)
    return _DAState(
        log_step=jnp.log(eps),
        log_step_avg=jnp.log(eps),
        h_bar=jnp.asarray(0.0, dtype),
        mu=jnp.log(10.0 * eps),
        count=jnp.asarray(0.0, dtype),
    )


def _da_update(s: _DAState, accept_prob, target):
    gamma, t0, kappa = 0.05, 10.0, 0.75
    m = s.count + 1.0
    eta = 1.0 / (m + t0)
    h_bar = (1.0 - eta) * s.h_bar + eta * (target - accept_prob)
    log_step = s.mu - jnp.sqrt(m) / gamma * h_bar
    w = m ** (-kappa)
    log_step_avg = w * log_step + (1.0 - w) * s.log_step_avg
    return _DAState(log_step, log_step_avg, h_bar, s.mu, m)


class _Welford(NamedTuple):
    count: jax.Array
    mean: jax.Array
    m2: jax.Array


def _welford_init(dim, dtype):
    return _Welford(
        jnp.asarray(0.0, dtype), jnp.zeros(dim, dtype), jnp.zeros(dim, dtype)
    )


def _welford_add_batch(w: _Welford, xs):
    """Merge a batch of samples xs (C, dim) via Chan's parallel update."""
    cb = jnp.asarray(xs.shape[0], xs.dtype)
    bmean = jnp.mean(xs, axis=0)
    bm2 = jnp.sum((xs - bmean) ** 2, axis=0)
    delta = bmean - w.mean
    tot = w.count + cb
    mean = w.mean + delta * cb / tot
    m2 = w.m2 + bm2 + delta ** 2 * w.count * cb / tot
    return _Welford(tot, mean, m2)


def _welford_variance(w: _Welford):
    """Regularized variance (Stan's shrinkage toward 1e-3)."""
    var = w.m2 / jnp.maximum(w.count - 1.0, 1.0)
    n = w.count
    return (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))


class _WelfordCov(NamedTuple):
    """Full-covariance Welford accumulator for the dense tail block."""

    count: jax.Array
    mean: jax.Array    # (k,)
    m2: jax.Array      # (k, k) sum of centered outer products


def _welford_cov_init(k, dtype):
    return _WelfordCov(
        jnp.asarray(0.0, dtype), jnp.zeros(k, dtype), jnp.zeros((k, k), dtype)
    )


def _welford_cov_add_batch(w: _WelfordCov, xs):
    """Merge a batch xs (C, k) via Chan's parallel covariance update."""
    cb = jnp.asarray(xs.shape[0], xs.dtype)
    bmean = jnp.mean(xs, axis=0)
    xc = xs - bmean
    bm2 = xc.T @ xc
    delta = bmean - w.mean
    tot = w.count + cb
    mean = w.mean + delta * cb / tot
    m2 = w.m2 + bm2 + jnp.outer(delta, delta) * w.count * cb / tot
    return _WelfordCov(tot, mean, m2)


def _welford_covariance(w: _WelfordCov, shrinkage: float = 0.0):
    """Regularized covariance (Stan's dense-metric shrinkage toward
    1e-3 * I), mirroring _welford_variance. ``shrinkage`` additionally
    pulls the off-diagonals toward zero (correlation shrinkage; marginals
    untouched) — see SamplerConfig.dense_shrinkage."""
    cov = w.m2 / jnp.maximum(w.count - 1.0, 1.0)
    n = w.count
    eye = jnp.eye(w.mean.shape[0], dtype=w.mean.dtype)
    cov = (n / (n + 5.0)) * cov + 1e-3 * (5.0 / (n + 5.0)) * eye
    if shrinkage > 0.0:
        s = jnp.asarray(shrinkage, cov.dtype)
        cov = (1.0 - s) * cov + s * jnp.diag(jnp.diag(cov))
    return cov


class ChainStats(NamedTuple):
    step_size: jax.Array          # final adapted step size (scalar)
    inv_mass: jax.Array           # (dim,) final inverse mass diagonal
    accept_probs: jax.Array       # (num_results, C)
    num_leapfrogs: jax.Array      # (num_results, C)
    divergences: jax.Array        # (num_results, C) bool
    depths: jax.Array             # (num_results, C)
    tail_inv_mass: jax.Array | None = None  # (k, k) dense tail block
    # (R-1,) per-adjacent-rung-pair swap acceptance rates (PT runs only)
    pt_swap_accept: jax.Array | None = None
    # host wall-clock phase decomposition (profile_timings=True only):
    # eps_init_s, warmup_s, sample_dispatch_s, sample_first_dispatch_s
    # (includes trace+compile of the block executable), sample_stage_s,
    # staged_bytes, sample_drain_s, sample_total_s
    timings: dict | None = None


def run_nuts_chains(
    tempered_logp_grad: Callable,   # (q (dim,), beta_temp) -> (logp, grad)
    q0: jax.Array,                  # (C, dim) initial chain states
    key: jax.Array,
    config: SamplerConfig = SamplerConfig(),
):
    """Run warmup + sampling for C chains; returns (samples, ChainStats).

    samples has shape (num_results, C, dim). The whole procedure is one jit:
    two lax.scans (warmup, sampling), vmapped NUTS inside.

    Matmul precision is pinned to HIGHEST: at default precision XLA may
    run float32 dots on GPU tensor cores in TF32 (10-bit mantissa). On an
    H100, at 256 vmapped chains, TF32 measured 100-350x less accurate than
    HIGHEST on the SEIR value+grad (log-density differences 5.3e-4 against
    1.5e-6, relative) and 500-1200x on the Lorenz N_I=1025 block-banded
    matvec and back substitution; chip_smoke.py prints the TF32 error of
    each posterior op beside the HIGHEST one. What TF32 would do to
    acceptance is not measured.
    """
    with jax.default_matmul_precision(config.matmul_precision):
        return _run_nuts_chains_impl(tempered_logp_grad, q0, key, config)


def _run_nuts_chains_impl(tempered_logp_grad, q0, key, config):
    C, dim = q0.shape
    dtype = q0.dtype
    cfg = NutsConfig(config.max_tree_depth, config.max_energy_diff)

    pt_R = len(config.pt_betas)
    pt = pt_R > 1
    if pt:
        pt_b = tuple(float(b) for b in config.pt_betas)
        if abs(pt_b[0] - 1.0) > 1e-12:
            raise ValueError(f"pt_betas must start at 1.0, got {pt_b}")
        if any(b2 >= b1 for b1, b2 in zip(pt_b, pt_b[1:])) or pt_b[-1] <= 0:
            raise ValueError(
                f"pt_betas must be strictly decreasing and positive: {pt_b}"
            )
        if C % pt_R:
            raise ValueError(
                f"num chains ({C}) must divide by the PT ladder length "
                f"({pt_R})"
            )
        if config.use_annealing and config.anneal_mode == "reference":
            raise ValueError(
                "pt_betas requires a fixed beta=1 sampling target: use "
                "use_annealing=False or anneal_mode='warmup_only' (the "
                "'reference' schedule tempers the sampling phase itself)"
            )
        if config.pt_swap_every < 1:
            raise ValueError("pt_swap_every must be >= 1")
        pt_M = C // pt_R
        # per-chain rung temperature and eps stability scale (rung-major)
        pt_betas_c = jnp.repeat(jnp.asarray(pt_b, dtype), pt_M)
        pt_eps_scale_c = pt_betas_c ** -0.5

    num_adapt = int(config.adaptation_fraction * config.num_burnin_steps)
    win_lo = int(config.mass_window_begin * config.num_burnin_steps)
    win_hi = int(config.mass_window_end * config.num_burnin_steps)
    win2_lo = int(config.mass_window2_begin * config.num_burnin_steps)
    win2_hi = int(config.mass_window2_end * config.num_burnin_steps)
    two_windows = config.adapt_mass_matrix and win2_hi > win2_lo
    if two_windows:
        if win_hi <= win_lo:
            raise ValueError(
                "mass_window2 requires a valid first window "
                f"(got [{win_lo}, {win_hi}))"
            )
        if win2_lo < win_hi:
            raise ValueError(
                f"mass_window2 [{win2_lo}, {win2_hi}) must start at or "
                f"after mass_window_end ({win_hi})"
            )
        if win2_hi >= num_adapt:
            raise ValueError(
                f"mass_window2 must end (step {win2_hi}) before step-size "
                f"adaptation does (step {num_adapt}): the step size has to "
                "re-adapt to the re-estimated metric"
            )

    def temp_at(step):
        if not config.use_annealing:
            return jnp.asarray(1.0, dtype)
        t = log_temperature_schedule(step, config.anneal_min_temp).astype(dtype)
        if config.anneal_mode == "warmup_only":
            # Ramp back to temp=1 early enough that everything frozen for
            # the sampling phase was adapted AT the temperature actually
            # sampled: by the start of the mass window when mass adaptation
            # is on (Welford must measure the beta=1 posterior — see the
            # mass_window_begin comment above for the measured failure),
            # else by the end of step-size adaptation.
            ramp_end = num_adapt
            if config.adapt_mass_matrix and win_hi > win_lo:
                ramp_end = min(ramp_end, win_lo)
            ramp = jnp.clip(
                step.astype(dtype) / jnp.asarray(max(ramp_end, 1), dtype),
                0.0, 1.0,
            )
            return jnp.maximum(t, ramp)
        return t

    if config.algorithm == "hmc":
        from magi_v2_tpu.sampler.hmc import make_hmc_step

        _hmc = make_hmc_step(config.hmc_num_leapfrogs,
                             config.max_energy_diff)

        def step_chains(keys, qs, eps, inv_mass, beta_temp):
            lp = lambda q: tempered_logp_grad(q, beta_temp)
            # one shared jittered trajectory length per step: keeps every
            # chain in lockstep (the whole point of the HMC mode)
            if config.hmc_jitter:
                u = jax.random.uniform(jax.random.fold_in(keys[0], 1))
                L = jnp.maximum(
                    1,
                    jnp.ceil(u * config.hmc_num_leapfrogs).astype(jnp.int32),
                )
            else:
                L = jnp.asarray(config.hmc_num_leapfrogs, jnp.int32)
            return jax.vmap(
                lambda k, q: _hmc(lp, k, q, eps, inv_mass, L)
            )(keys, qs)
    elif config.algorithm == "nuts":
        def step_chains(keys, qs, eps, inv_mass, beta_temp):
            lp = lambda q: tempered_logp_grad(q, beta_temp)
            return jax.vmap(
                lambda k, q: nuts_step(lp, k, q, eps, inv_mass, cfg)
            )(keys, qs)
    else:
        raise ValueError(f"unknown algorithm {config.algorithm!r}")

    if pt:
        # sampling-phase PT transition: per-chain rung beta + scaled eps.
        # A separate function (not a per-chain-beta generalization of
        # step_chains) so the non-PT path's jitted graphs stay untouched.
        if config.algorithm == "hmc":
            def step_chains_pt(keys, qs, eps, inv_mass):
                if config.hmc_jitter:
                    u = jax.random.uniform(jax.random.fold_in(keys[0], 1))
                    L = jnp.maximum(
                        1,
                        jnp.ceil(
                            u * config.hmc_num_leapfrogs
                        ).astype(jnp.int32),
                    )
                else:
                    L = jnp.asarray(config.hmc_num_leapfrogs, jnp.int32)
                return jax.vmap(
                    lambda k, q, b, s: _hmc(
                        lambda r: tempered_logp_grad(r, b),
                        k, q, eps * s, inv_mass, L,
                    )
                )(keys, qs, pt_betas_c, pt_eps_scale_c)
        else:
            def step_chains_pt(keys, qs, eps, inv_mass):
                return jax.vmap(
                    lambda k, q, b, s: nuts_step(
                        lambda r: tempered_logp_grad(r, b),
                        k, q, eps * s, inv_mass, cfg,
                    )
                )(keys, qs, pt_betas_c, pt_eps_scale_c)

        one = jnp.asarray(1.0, dtype)

        def pt_swap(key, qs, swap_idx):
            """Even-odd replica exchange between adjacent rungs. Exact for
            lp_beta = beta * lp (posterior.py:374): log alpha =
            (beta_i - beta_j) * (lp(q_j) - lp(q_i)). Returns the swapped
            states plus per-pair proposal/accept counts for diagnostics."""
            lps = jax.vmap(
                lambda q: tempered_logp_grad(q, one)[0]
            )(qs)
            lpr = lps.reshape(pt_R, pt_M)
            qr = qs.reshape(pt_R, pt_M, dim)
            parity = swap_idx % 2
            keys = jax.random.split(key, pt_R - 1)
            prop = jnp.zeros((pt_R - 1,), dtype)
            accs = jnp.zeros((pt_R - 1,), dtype)
            for i in range(pt_R - 1):
                do = parity == (i % 2)
                dlb = jnp.asarray(pt_b[i] - pt_b[i + 1], dtype)
                log_alpha = dlb * (lpr[i + 1] - lpr[i])       # (M,)
                u = jax.random.uniform(keys[i], (pt_M,), dtype)
                acc = do & jnp.isfinite(log_alpha) & (
                    jnp.log(u) < log_alpha
                )
                qi, qj = qr[i], qr[i + 1]
                qr = qr.at[i].set(jnp.where(acc[:, None], qj, qi))
                qr = qr.at[i + 1].set(jnp.where(acc[:, None], qi, qj))
                li, lj = lpr[i], lpr[i + 1]
                lpr = lpr.at[i].set(jnp.where(acc, lj, li))
                lpr = lpr.at[i + 1].set(jnp.where(acc, li, lj))
                prop = prop.at[i].add(
                    jnp.where(do, jnp.asarray(float(pt_M), dtype), 0.0)
                )
                accs = accs.at[i].add(jnp.sum(acc.astype(dtype)))
            return qr.reshape(C, dim), prop, accs

    def find_reasonable_step_size(q0_row, key, inv_mass, beta_temp):
        """Hoffman-Gelman Algorithm 4: double/halve eps until the one-leapfrog
        acceptance crosses 1/2. Without this, a fixed initial eps that is far
        too large for the state dimension sends dual averaging into a deep
        overshoot it cannot recover from within the adaptation window
        (measured: eps -> 1e-30 and frozen chains at dim 3081)."""
        logp0, grad0 = tempered_logp_grad(q0_row, beta_temp)
        p0 = mass_sample_momentum(inv_mass, key, q0_row.shape, dtype)
        H0 = -logp0 + mass_kinetic(inv_mass, p0)

        def log_accept(eps):
            p_half = p0 + 0.5 * eps * grad0
            q1 = q0_row + eps * mass_vel(inv_mass, p_half)
            logp1, grad1 = tempered_logp_grad(q1, beta_temp)
            p1 = p_half + 0.5 * eps * grad1
            H1 = -logp1 + mass_kinetic(inv_mass, p1)
            dH = jnp.where(jnp.isfinite(H1), H1 - H0, jnp.inf)
            return -dH

        eps0 = jnp.asarray(config.initial_step_size, dtype)
        la0 = log_accept(eps0)
        direction = jnp.where(la0 > jnp.log(0.5), 1.0, -1.0).astype(dtype)

        def cond(c):
            eps, la, it = c
            return (direction * la > direction * jnp.log(0.5)) & (it < 40)

        def body(c):
            eps, _, it = c
            eps = eps * jnp.exp2(direction)
            return eps, log_accept(eps), it + 1

        eps, _, _ = jax.lax.while_loop(
            cond, body, (eps0, la0, jnp.asarray(0, jnp.int32))
        )
        return eps

    progress_every = config.progress_every

    def maybe_progress(phase, step, eps, infos):
        if not progress_every:
            return

        def cb(step, eps, acc, depth, div):
            print(
                f"[sampler] {phase} step {int(step):>6} eps={float(eps):.5f} "
                f"accept={float(acc):.3f} depth={float(depth):.1f} "
                f"div={float(div):.4f}",
                flush=True,
            )

        ft = infos.accept_prob.dtype
        jax.lax.cond(
            step % progress_every == 0,
            lambda: jax.debug.callback(
                cb, step, eps, jnp.mean(infos.accept_prob),
                jnp.mean(infos.depth.astype(ft)),
                jnp.mean(infos.diverging.astype(ft)),
            ),
            lambda: None,
        )

    def warmup_step(carry, step):
        qs, key, da, welford, inv_mass = carry
        key, *chain_keys = jax.random.split(key, C + 1)
        eps = jnp.exp(
            jnp.where(da.count < num_adapt, da.log_step, da.log_step_avg)
        )
        qs, infos = step_chains(
            jnp.stack(chain_keys), qs, eps, inv_mass, temp_at(step)
        )
        maybe_progress("warmup", step, eps, infos)

        da = jax.lax.cond(
            step < num_adapt,
            lambda d: _da_update(d, jnp.mean(infos.accept_prob),
                                 config.target_accept),
            lambda d: d,
            da,
        )

        if config.adapt_mass_matrix and win_hi > win_lo:
            def add_batch(w):
                wf, wf_tail = w
                wf = _welford_add_batch(wf, qs)
                if wf_tail is not None:
                    wf_tail = _welford_cov_add_batch(
                        wf_tail, qs[:, -config.dense_tail_size:]
                    )
                return (wf, wf_tail)

            in_window = (step >= win_lo) & (step < win_hi)
            if two_windows:
                in_window |= (step >= win2_lo) & (step < win2_hi)
            welford = jax.lax.cond(in_window, add_batch,
                                   lambda w: w, welford)

            # at window end: set mass from pooled variance, restart DA
            # shrinkage target around the current step size (Stan-style)
            def apply_mass(args):
                da, welford, inv_mass = args
                wf, wf_tail = welford
                var = _welford_variance(wf)
                if wf_tail is None:
                    new_inv_mass = var
                else:
                    cov = _welford_covariance(wf_tail,
                                              config.dense_shrinkage)
                    if two_windows and config.mass_window1_diag:
                        # first window applies scales only; the dense
                        # correlations wait for window 2's estimate
                        cov = jnp.where(step == win_hi,
                                        jnp.diag(jnp.diag(cov)), cov)
                    new_inv_mass = mass_from_moments(var, cov)
                eps_now = jnp.exp(da.log_step)
                # reset the accumulators: a second window (if configured)
                # re-estimates from scratch under the just-applied metric
                fresh = (
                    _welford_init(dim, dtype),
                    None if wf_tail is None
                    else _welford_cov_init(config.dense_tail_size, dtype),
                )
                return (_da_init(eps_now, dtype)._replace(
                    mu=jnp.log(10.0 * eps_now)
                ), fresh, new_inv_mass)

            apply_now = step == win_hi
            if two_windows:
                apply_now |= step == win2_hi
            da, welford, inv_mass = jax.lax.cond(
                apply_now,
                apply_mass,
                lambda args: args,
                (da, welford, inv_mass),
            )

        return (qs, key, da, welford, inv_mass), None

    @jax.jit
    def warmup_blk(carry, steps):
        return jax.lax.scan(warmup_step, carry, steps)[0]

    if pt:
        def one_transition(carry, step):
            qs, key, eps_final, inv_mass, (prop, accs) = carry
            key, kswap, *chain_keys = jax.random.split(key, C + 2)
            qs, infos = step_chains_pt(
                jnp.stack(chain_keys), qs, eps_final, inv_mass
            )
            maybe_progress("sample", step, eps_final, infos)
            rel = step - config.num_burnin_steps
            do_swap = (rel + 1) % config.pt_swap_every == 0
            qs, dprop, daccs = jax.lax.cond(
                do_swap,
                lambda: pt_swap(kswap, qs, rel // config.pt_swap_every),
                lambda: (qs, jnp.zeros((pt_R - 1,), dtype),
                         jnp.zeros((pt_R - 1,), dtype)),
            )
            carry = (qs, key, eps_final, inv_mass,
                     (prop + dprop, accs + daccs))
            return carry, infos
    else:
        def one_transition(carry, step):
            qs, key, eps_final, inv_mass = carry
            key, *chain_keys = jax.random.split(key, C + 1)
            qs, infos = step_chains(
                jnp.stack(chain_keys), qs, eps_final, inv_mass, temp_at(step)
            )
            maybe_progress("sample", step, eps_final, infos)
            return (qs, key, eps_final, inv_mass), infos

    if config.thin == 1:
        def draw_step(carry, draw_idx):
            step = config.num_burnin_steps + draw_idx
            carry, infos = one_transition(carry, step)
            return carry, (carry[0], infos)
    else:
        def draw_step(carry, draw_idx):
            base = config.num_burnin_steps + draw_idx * config.thin
            carry, infos = jax.lax.scan(
                one_transition, carry, base + jnp.arange(config.thin)
            )
            last = jax.tree.map(lambda a: a[-1], infos)
            return carry, (carry[0], last)

    @jax.jit
    def sample_blk(carry, draw_idxs):
        return jax.lax.scan(draw_step, carry, draw_idxs)

    def blocks(total, transitions_per_step=1):
        """Split ``total`` scan steps into dispatch blocks. The block budget
        is in TRANSITIONS, so a thinned sampling draw — which runs ``thin``
        transitions — consumes thin units of it."""
        B = config.dispatch_block_steps
        if B > 0 and transitions_per_step > 1:
            B = max(1, B // transitions_per_step)
        if B <= 0 or B >= total:
            return [(0, total)]
        out = [(s, min(B, total - s)) for s in range(0, total, B)]
        return out

    ck = config.checkpoint_path
    fingerprint = _ckpt_fingerprint(config, C, dim, key, q0) if ck else ""
    resume = _ckpt_load_state(ck, fingerprint) if ck else None
    restore = _ckpt_restore_carry
    prof = config.profile_timings
    timings: dict | None = {} if prof else None

    # --- warmup: blocks of steps, state carried across dispatches
    inv_mass0 = identity_mass(dim, config.dense_tail_size, dtype)
    pt_stats0 = (
        (jnp.zeros((pt_R - 1,), dtype), jnp.zeros((pt_R - 1,), dtype))
        if pt else None
    )

    def make_scarry(qs, key, eps, inv_mass):
        base = (qs, key, eps, inv_mass)
        return base + (pt_stats0,) if pt else base

    if resume is not None and resume[0] == "sample":
        # warmup already completed in a previous process — skip it entirely
        scarry = restore(
            make_scarry(q0, key, jnp.asarray(0.1, dtype), inv_mass0),
            resume[2],
        )
        sample_done = resume[1]
    else:
        welford0 = (
            _welford_init(dim, dtype),
            _welford_cov_init(config.dense_tail_size, dtype)
            if config.dense_tail_size > 0 else None,
        )
        if resume is not None:            # mid-warmup checkpoint
            wcarry = restore(
                (q0, key, _da_init(0.1, dtype), welford0, inv_mass0),
                resume[2],
            )
            warmup_done = resume[1]
        else:
            t0 = time.time()
            key, key_eps = jax.random.split(key)
            eps_init = jax.jit(find_reasonable_step_size)(
                q0[0], key_eps, inv_mass0, temp_at(jnp.asarray(0))
            )
            if prof:
                jax.block_until_ready(eps_init)
                timings["eps_init_s"] = time.time() - t0
            wcarry = (q0, key, _da_init(eps_init, dtype), welford0, inv_mass0)
            warmup_done = 0
        t_warm0 = time.time()
        for start, size in blocks(config.num_burnin_steps):
            if start + size <= warmup_done:
                continue
            t_blk = time.time()
            wcarry = warmup_blk(wcarry, start + jnp.arange(size))
            if prof:
                jax.block_until_ready(wcarry[0])
                timings.setdefault("warmup_block_walls_s", []).append(
                    time.time() - t_blk
                )
            if ck:
                _ckpt_save_state(ck, "warmup", start + size,
                                 wcarry, fingerprint)
        qs, key, da, _, inv_mass = wcarry
        scarry = make_scarry(qs, key, jnp.exp(da.log_step_avg), inv_mass)
        if prof:
            jax.block_until_ready(qs)
            timings["warmup_s"] = time.time() - t_warm0
        sample_done = 0
        if ck:
            _ckpt_save_state(ck, "sample", 0, scarry, fingerprint)

    # --- sampling: blocks of draws. Draws accumulate ON DEVICE when the
    # run fits under stage_above_bytes; above the budget — or whenever
    # checkpointing, which needs host files — each block is staged to
    # HOST as it completes, so device memory holds one block of draws
    # rather than the whole run.
    # Infos are normalized to plain dicts so live blocks and
    # checkpoint-loaded blocks concatenate through one code path.
    draws_nbytes = config.num_results * C * dim * q0.dtype.itemsize
    stage_host = bool(ck) or (
        config.dispatch_block_steps > 0
        and draws_nbytes > config.stage_above_bytes
    )
    sample_chunks, info_chunks = [], []
    pa = {"dispatch_s": 0.0, "first_dispatch_s": None,
          "stage_s": 0.0, "staged_bytes": 0}

    def finalize_block(start, size, s_blk, i_blk, carry_after):
        """Fetch/persist one completed block. Called AFTER the next block's
        dispatch is in flight, so the device->host transfer (~90 MB at
        Lorenz-1025 x 256 chains) overlaps the device compute of the
        following block instead of serializing with it. The persisted
        carry is the one matching the persisted _next, not the loop's
        current carry."""
        i_blk = i_blk._asdict()
        if stage_host:
            t0 = time.time()
            s_blk = np.asarray(s_blk)
            i_blk = {k: np.asarray(v) for k, v in i_blk.items()}
            pa["stage_s"] += time.time() - t0
            pa["staged_bytes"] += s_blk.nbytes + sum(
                v.nbytes for v in i_blk.values()
            )
        if ck:
            _ckpt_save_draws(ck, start, s_blk, i_blk)
            _ckpt_save_state(ck, "sample", start + size, carry_after,
                             fingerprint)
        sample_chunks.append(s_blk)
        info_chunks.append(i_blk)

    pending = None
    t_sample0 = time.time()
    for start, size in blocks(config.num_results, config.thin):
        if ck and start + size <= sample_done:
            loaded = _ckpt_load_draws(ck, start)
            if loaded is not None:
                sample_chunks.append(loaded[0])
                info_chunks.append(loaded[1])
                continue
            # state says done but the draw file is missing (partial write
            # cleanup): fall through and recompute from the current carry —
            # impossible unless files were deleted by hand; re-running the
            # block from a later carry would be WRONG, so fail loudly.
            raise FileNotFoundError(
                f"checkpoint state at {ck!r} marks block {start} complete "
                f"but draws_{start:06d}.npz is missing; delete state.npz "
                "to restart"
            )
        t0 = time.time()
        scarry, (s_blk, i_blk) = sample_blk(scarry, start + jnp.arange(size))
        if prof:
            jax.block_until_ready(scarry[0])
            timings.setdefault("block_walls_s", []).append(
                time.time() - t0
            )
        dt = time.time() - t0
        pa["dispatch_s"] += dt
        if pa["first_dispatch_s"] is None:
            pa["first_dispatch_s"] = dt
        if pending is not None:
            finalize_block(*pending)
        pending = (start, size, s_blk, i_blk, scarry)
    if pending is not None:
        finalize_block(*pending)
    if len(sample_chunks) == 1:
        samples, infos = sample_chunks[0], info_chunks[0]
    else:
        cat = np.concatenate if stage_host else jnp.concatenate
        samples = cat(sample_chunks, axis=0)
        infos = jax.tree.map(
            lambda *xs: cat(xs, axis=0), *info_chunks
        )

    if prof:
        t0 = time.time()
        jax.block_until_ready(jax.tree.leaves(scarry))
        jax.block_until_ready(samples)
        timings["sample_drain_s"] = time.time() - t0
        timings["sample_total_s"] = time.time() - t_sample0
        timings["sample_dispatch_s"] = pa["dispatch_s"]
        timings["sample_first_dispatch_s"] = pa["first_dispatch_s"]
        timings["sample_stage_s"] = pa["stage_s"]
        timings["staged_bytes"] = pa["staged_bytes"]

    eps_final, inv_mass = scarry[2], scarry[3]
    pt_swap_accept = None
    if pt:
        prop, accs = scarry[4]
        pt_swap_accept = accs / jnp.maximum(prop, 1.0)
    stats = ChainStats(
        step_size=eps_final,
        inv_mass=mass_diag(inv_mass),
        accept_probs=infos["accept_prob"],
        num_leapfrogs=infos["num_leapfrogs"],
        divergences=infos["diverging"],
        depths=infos["depth"],
        tail_inv_mass=mass_tail_inv(inv_mass),
        pt_swap_accept=pt_swap_accept,
        timings=timings,
    )
    return samples, stats
