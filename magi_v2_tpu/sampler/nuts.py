"""Iterative No-U-Turn sampler as a single jittable, vmappable transition.

From-scratch JAX implementation of multinomial NUTS (Hoffman & Gelman 2014;
Betancourt 2017 for the multinomial/biased-progressive variant) operating on
a flat state vector. Replaces tfp.mcmc.NoUTurnSampler in the reference stack
(magi_v2.py:361-364). Design constraints, per the XLA execution model:

- No recursion: trajectory doubling is a lax.while_loop over depth; each
  subtree is built by a lax.while_loop over leaves with the O(log n)
  checkpoint scheme for U-turn detection (the same idea as NumPyro's
  iterative build): when leaf n (even) is created it is stored in checkpoint
  slot popcount(n); leaf n must check U-turns against slots
  popcount(n)-trailing_ones(n) .. popcount(n)-1 — a contiguous range.
- Fixed shapes everywhere: checkpoint storage is (max_depth, dim); per-leaf
  U-turn checks mask a fixed fori over max_depth slots.
- vmap-compatible: all control flow is lax, so chains batch cleanly; under
  vmap a while_loop runs until every lane terminates, with lanes masked out
  once done — the natural SIMD execution of divergent chains on an
  accelerator.

The target callable returns the *tempered* log-posterior; temperature enters
through the closure (threaded in-graph by the caller), fixing the reference's
out-of-graph step-counter crash (magi_v2.py:848-856, SURVEY.md §4).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from magi_v2_tpu.sampler.mass import (
    mass_kinetic,
    mass_sample_momentum,
    mass_vel,
)


class NutsConfig(NamedTuple):
    max_tree_depth: int = 10       # TFP NoUTurnSampler default
    max_energy_diff: float = 1000.0  # TFP divergence threshold


class _LeafState(NamedTuple):
    q: jax.Array
    p: jax.Array
    grad: jax.Array   # d logp / dq at q
    logp: jax.Array


def _kinetic(p, inv_mass):
    return mass_kinetic(inv_mass, p)


def _leapfrog(logp_grad_fn, leaf: _LeafState, eps, inv_mass):
    """One leapfrog step; eps carries the direction sign."""
    p_half = leaf.p + 0.5 * eps * leaf.grad
    q_new = leaf.q + eps * mass_vel(inv_mass, p_half)
    logp_new, grad_new = logp_grad_fn(q_new)
    p_new = p_half + 0.5 * eps * grad_new
    return _LeafState(q_new, p_new, grad_new, logp_new)


def _is_turning(q_minus, p_minus, q_plus, p_plus, inv_mass):
    """Original NUTS U-turn criterion with velocities v = M^{-1} p.

    ``q_plus`` MUST be the temporally-later endpoint: the OR of the two sign
    checks is not symmetric under endpoint relabeling, so callers building
    backward trajectories must orient dq by the integration direction.
    """
    dq = q_plus - q_minus
    return (jnp.dot(dq, mass_vel(inv_mass, p_minus)) < 0.0) | (
        jnp.dot(dq, mass_vel(inv_mass, p_plus)) < 0.0
    )


def _trailing_ones(n):
    # trailing ones of n == trailing zeros of n+1 == popcount((m & -m) - 1)
    m = n + 1
    return jax.lax.population_count((m & -m) - 1)


class _SubtreeResult(NamedTuple):
    edge: _LeafState        # outermost state reached (new trajectory endpoint)
    prop_q: jax.Array       # multinomial proposal within the subtree
    lsw: jax.Array          # log sum of leaf weights exp(-(H - H0))
    turning: jax.Array      # bool
    diverging: jax.Array    # bool
    sum_alpha: jax.Array    # sum of per-leaf accept probs (for dual averaging)
    n_leaves: jax.Array     # number of leaves actually evaluated


def _build_subtree(
    logp_grad_fn,
    edge: _LeafState,
    depth,
    eps_signed,
    inv_mass,
    H0,
    key,
    cfg: NutsConfig,
):
    """Build a subtree of 2^depth leapfrog leaves from ``edge`` (iteratively)."""
    dim = edge.q.shape[0]
    dt = edge.q.dtype
    num_leaves = jnp.asarray(1, jnp.int32) << depth

    ckpt_q0 = jnp.zeros((cfg.max_tree_depth, dim), dt)
    ckpt_p0 = jnp.zeros((cfg.max_tree_depth, dim), dt)

    init = dict(
        n=jnp.asarray(0, jnp.int32),
        leaf=edge,
        prop_q=edge.q,
        lsw=jnp.asarray(-jnp.inf, dt),
        turning=jnp.asarray(False),
        diverging=jnp.asarray(False),
        sum_alpha=jnp.asarray(0.0, dt),
        ckpt_q=ckpt_q0,
        ckpt_p=ckpt_p0,
        key=key,
    )

    def cond(c):
        return (c["n"] < num_leaves) & ~c["turning"] & ~c["diverging"]

    def body(c):
        n = c["n"]
        leaf = _leapfrog(logp_grad_fn, c["leaf"], eps_signed, inv_mass)
        H = -leaf.logp + _kinetic(leaf.p, inv_mass)
        dH = H - H0
        # NaN-safe: treat non-finite energies as divergent.
        dH = jnp.where(jnp.isfinite(dH), dH, jnp.inf)
        diverging = dH > cfg.max_energy_diff
        lw = -dH
        sum_alpha = c["sum_alpha"] + jnp.exp(jnp.minimum(0.0, -dH))

        # multinomial proposal within subtree
        lsw_new = jnp.logaddexp(c["lsw"], lw)
        key, sub = jax.random.split(c["key"])
        accept = jnp.log(jax.random.uniform(sub, dtype=dt)) < lw - lsw_new
        prop_q = jnp.where(accept, leaf.q, c["prop_q"])

        # checkpoint storage for even leaves at slot popcount(n)
        pc = jax.lax.population_count(n)
        is_even = (n & 1) == 0
        ckpt_q = jnp.where(
            is_even,
            c["ckpt_q"].at[pc].set(leaf.q),
            c["ckpt_q"],
        )
        ckpt_p = jnp.where(
            is_even,
            c["ckpt_p"].at[pc].set(leaf.p),
            c["ckpt_p"],
        )

        # U-turn checks against slots popcount(n)-t .. popcount(n)-1,
        # vectorized over all checkpoint slots with a mask (cheaper to
        # compile and execute than a fori_loop of dot products).
        # Orientation: in a backward subtree (eps < 0) the checkpoint leaf is
        # the temporally-LATER endpoint, so the displacement must be flipped
        # to trajectory-time order before the (asymmetric) criterion.
        t_ones = _trailing_ones(n)
        dir_sign = jnp.sign(eps_signed)
        dq = dir_sign * (leaf.q[None, :] - ckpt_q)        # (max_depth, dim)
        v_cur = mass_vel(inv_mass, leaf.p)
        dots_ckpt = jnp.sum(dq * mass_vel(inv_mass, ckpt_p), axis=-1)
        dots_cur = dq @ v_cur
        slots = jnp.arange(cfg.max_tree_depth)
        active = (slots >= pc - t_ones) & (slots <= pc - 1)
        turning = jnp.any(active & ((dots_ckpt < 0.0) | (dots_cur < 0.0)))

        return dict(
            n=n + 1,
            leaf=leaf,
            prop_q=prop_q,
            lsw=lsw_new,
            turning=turning,
            diverging=diverging,
            sum_alpha=sum_alpha,
            ckpt_q=ckpt_q,
            ckpt_p=ckpt_p,
            key=key,
        )

    out = jax.lax.while_loop(cond, body, init)
    return _SubtreeResult(
        edge=out["leaf"],
        prop_q=out["prop_q"],
        lsw=out["lsw"],
        turning=out["turning"],
        diverging=out["diverging"],
        sum_alpha=out["sum_alpha"],
        n_leaves=out["n"],
    )


class NutsInfo(NamedTuple):
    accept_prob: jax.Array   # mean leaf acceptance (dual-averaging statistic)
    num_leapfrogs: jax.Array
    diverging: jax.Array
    depth: jax.Array


@partial(jax.jit, static_argnums=(0, 5))
def nuts_step(
    logp_grad_fn: Callable,
    key: jax.Array,
    q: jax.Array,
    step_size: jax.Array,
    inv_mass: jax.Array,
    cfg: NutsConfig = NutsConfig(),
):
    """One NUTS transition from flat position ``q``.

    logp_grad_fn(q) -> (logp, grad). Returns (q_new, NutsInfo).
    """
    dt = q.dtype
    key_mom, key_loop = jax.random.split(key)
    logp, grad = logp_grad_fn(q)
    p0 = mass_sample_momentum(inv_mass, key_mom, q.shape, dt)
    H0 = -logp + _kinetic(p0, inv_mass)
    root = _LeafState(q, p0, grad, logp)

    init = dict(
        depth=jnp.asarray(0, jnp.int32),
        minus=root,
        plus=root,
        prop_q=q,
        lsw=jnp.asarray(0.0, dt),  # root leaf weight exp(-(H0-H0)) = 1
        terminated=jnp.asarray(False),
        diverging=jnp.asarray(False),
        sum_alpha=jnp.asarray(0.0, dt),
        n_leaves=jnp.asarray(0, jnp.int32),
        key=key_loop,
    )

    def cond(c):
        return (c["depth"] < cfg.max_tree_depth) & ~c["terminated"]

    def body(c):
        key, key_dir, key_sub, key_acc = jax.random.split(c["key"], 4)
        go_right = jax.random.bernoulli(key_dir)
        eps_signed = jnp.where(go_right, step_size, -step_size).astype(dt)
        edge = jax.tree.map(
            lambda a, b: jnp.where(go_right, a, b), c["plus"], c["minus"]
        )

        sub = _build_subtree(
            logp_grad_fn, edge, c["depth"], eps_signed, inv_mass, H0,
            key_sub, cfg,
        )

        ok = ~sub.turning & ~sub.diverging
        # biased progressive across-subtree acceptance
        log_accept_prob = jnp.minimum(0.0, sub.lsw - c["lsw"])
        take = ok & (
            jnp.log(jax.random.uniform(key_acc, dtype=dt)) < log_accept_prob
        )
        prop_q = jnp.where(take, sub.prop_q, c["prop_q"])
        lsw = jnp.where(ok, jnp.logaddexp(c["lsw"], sub.lsw), c["lsw"])

        # update trajectory endpoints only if the subtree is kept
        upd = lambda old, new: jax.tree.map(
            lambda o, n_: jnp.where(ok, n_, o), old, new
        )
        plus = upd(c["plus"], jax.tree.map(
            lambda e, o: jnp.where(go_right, e, o), sub.edge, c["plus"]))
        minus = upd(c["minus"], jax.tree.map(
            lambda e, o: jnp.where(go_right, o, e), sub.edge, c["minus"]))

        whole_turn = _is_turning(
            minus.q, minus.p, plus.q, plus.p, inv_mass
        )
        terminated = ~ok | whole_turn

        return dict(
            depth=c["depth"] + 1,
            minus=minus,
            plus=plus,
            prop_q=prop_q,
            lsw=lsw,
            terminated=terminated,
            diverging=c["diverging"] | sub.diverging,
            sum_alpha=c["sum_alpha"] + sub.sum_alpha,
            n_leaves=c["n_leaves"] + sub.n_leaves,
            key=key,
        )

    out = jax.lax.while_loop(cond, body, init)
    n = jnp.maximum(out["n_leaves"], 1)
    info = NutsInfo(
        accept_prob=out["sum_alpha"] / n.astype(dt),
        num_leapfrogs=out["n_leaves"],
        diverging=out["diverging"],
        depth=out["depth"],
    )
    return out["prop_q"], info
