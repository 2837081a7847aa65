"""Fixed-length (jittered) HMC transition — the synchronous fast path.

Vmapped NUTS pays a SIMD tax: a lax.while_loop under vmap runs every chain
until the DEEPEST tree of the batch finishes each step, so wall-clock is set
by the max trajectory length over 256 chains. This kernel runs a fixed
number of leapfrogs per step — identical for all chains, with the length
jittered by a shared uniform factor per step (breaking resonances the way
ChEES-HMC does) — so the batch stays in lockstep and no lane idles.

Metropolis-corrected, so the stationary distribution is exact. Use
``SamplerConfig(algorithm="hmc", hmc_num_leapfrogs=L)``; step size is
adapted by the same dual-averaging machinery (acceptance statistic =
min(1, exp(-dH))).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from magi_v2_tpu.sampler.mass import (
    mass_kinetic,
    mass_sample_momentum,
    mass_vel,
)


class HmcInfo(NamedTuple):
    accept_prob: jax.Array
    num_leapfrogs: jax.Array
    diverging: jax.Array
    depth: jax.Array  # log2(leapfrogs), for display parity with NUTS


def make_hmc_step(max_leapfrogs: int, max_energy_diff: float = 1000.0):
    """HMC step running EXACTLY the traced ``num_leapfrogs`` iterations.

    The jittered length is one shared scalar per step (run.py draws it once
    for the whole chain batch), so a ``lax.while_loop`` bounded by the traced
    value stays in lockstep under vmap — every lane's condition is identical,
    so the batch executes num_leapfrogs iterations, not ``max_leapfrogs``.
    The previous masked-scan formulation always paid ``max_leapfrogs``
    leapfrogs per step; with the uniform [1, L] jitter that computed and
    discarded half the device work (mean useful length ~L/2 at cost L).
    ``max_leapfrogs`` is kept as a documentation/config bound only.
    """

    del max_leapfrogs  # cost now tracks the traced length directly

    def step(logp_grad_fn, key, q, step_size, inv_mass, num_leapfrogs):
        dt = q.dtype
        key_mom, key_acc = jax.random.split(key)
        logp0, grad0 = logp_grad_fn(q)
        p0 = mass_sample_momentum(inv_mass, key_mom, q.shape, dt)
        H0 = -logp0 + mass_kinetic(inv_mass, p0)

        def cond(carry):
            i, _, _, _, _ = carry
            return i < num_leapfrogs

        def body(carry):
            i, qc, pc, gc, _ = carry
            p_half = pc + 0.5 * step_size * gc
            q_new = qc + step_size * mass_vel(inv_mass, p_half)
            logp, g_new = logp_grad_fn(q_new)
            p_new = p_half + 0.5 * step_size * g_new
            return (i + 1, q_new, p_new, g_new, logp)

        _, q1, p1, _, logp1 = jax.lax.while_loop(
            cond, body, (jnp.asarray(0, jnp.int32), q, p0, grad0, logp0)
        )
        H1 = -logp1 + mass_kinetic(inv_mass, p1)
        dH = H1 - H0
        dH = jnp.where(jnp.isfinite(dH), dH, jnp.inf)
        accept_prob = jnp.exp(jnp.minimum(0.0, -dH))
        diverging = dH > max_energy_diff
        accept = (
            jax.random.uniform(key_acc, dtype=dt) < accept_prob
        ) & ~diverging
        q_out = jnp.where(accept, q1, q)
        info = HmcInfo(
            accept_prob=jnp.where(diverging, 0.0, accept_prob).astype(dt),
            num_leapfrogs=num_leapfrogs,
            diverging=diverging,
            depth=jnp.ceil(
                jnp.log2(jnp.maximum(num_leapfrogs, 1).astype(dt))
            ).astype(jnp.int32),
        )
        return q_out, info

    return step
