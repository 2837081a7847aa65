"""Sampler coordinate-system builders for MAGI_v2.predict().

Each ``reparam`` x ``storage`` combination is a *linear, fixed* change of
the X-block coordinates (constant Jacobian), so the posterior over X is
identical in all of them — only the sampler geometry differs (tested in
tests/test_precond.py). This module owns the construction of the fused
``logp_grad`` for each mode, the initial coordinates, the post-sampling
unwhitening, and the mid-warmup Gauss-Newton re-anchoring
(``precond_refresh_steps``), extracted from the reference-parity facade
(predict() maps onto reference magi_v2.py:286-396; the modes themselves
have no reference counterpart — the reference samples centered X only).

Modes:

- ``precond`` + ``banded``: banded Gauss-Newton whitening z = U (x - mu)
  with U the banded Cholesky factor of the GN precision; every per-leapfrog
  operator is O(ND*b). The large-grid mode. NOTE: the TARGET evaluates
  through band-truncated operators — a materially different posterior
  when the truncation drops real operator mass (api band_truncation).
- ``precond`` + ``hybrid``: the banded GN whitening around the EXACT
  dense-operator posterior — truncation applies to the preconditioner
  only, never the target. The accuracy-preserving large-grid mode
  (converged at N_I=1025).
- ``precond`` + ``dense``: full-state GN whitening via a dense (ND, ND)
  eigh factor. The small-grid mode (it collapsed in f32 at N_I ~ 1k).
- ``whitened``: GP-prior whitening only (z = C^{-1/2} (x - mu)).
- ``centered``: X sampled directly, like the reference.

Known-sigma pinning (``sigma_sqs_fixed``) is applied here, INSIDE the mode
builder, so a Gauss-Newton re-anchor rebuild keeps the pinning — wrapping
outside the builder silently dropped it after a refresh.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

def pin_sigma_coordinates(logp_grad, sig_pre_fix, N_I: int, D: int):
    """Wrap a fused target so the sigma_pre block is pinned at the known
    values (the original magi package's useFixedSigma): the wrapped target
    substitutes the fixed values and zeroes their gradient, so the
    coordinates carry no potential. Under leapfrog a zero-force coordinate
    keeps its momentum exactly (its kinetic term contributes 0 to every
    energy DIFFERENCE), so acceptance is identical to a sampler without
    the coordinates."""
    lo = N_I * D
    hi = lo + D

    def pinned(q, beta_temp, _blp=logp_grad):
        qf = q.at[lo:hi].set(sig_pre_fix)
        v, g = _blp(qf, beta_temp)
        return v, g.at[lo:hi].set(0.0)

    return pinned


@dataclass
class SamplingMode:
    """A fused target + the coordinate maps predict() needs around it.

    - ``logp_grad(q, beta_temp) -> (logp, grad)`` — sigma pinning (if any)
      already applied.
    - ``X0`` — initial X-block coordinates, shape (N_I, D), in the
      sampling dtype (z0 for the whitened modes, Xhat for centered).
    - ``unwhiten(Z, mu, factor)`` / ``factor`` — map z draws back to
      trajectories (None for centered).
    - ``draw_bytes`` — per-(draw, chain) device bytes of one unwhitening
      matvec (chunk sizing); 0 for centered.
    - ``gn`` — banded-GN parts dict (U_blocks/U_dinv/ref/z0/z064/info) or
      None.
    - ``rebuild(anchor_X, anchor_th)`` — re-anchor the linearization
      (banded GN only; None elsewhere).
    - ``whiten64(X) -> z`` — map ONE natural-coordinate trajectory
      (N_I, D numpy, any float dtype) into this mode's X-block
      coordinates, computed in float64 exactly like ``X0`` was (identity
      for centered). Used by predict(init_states=...) to accept
      user-supplied per-chain initial trajectories.
    """

    reparam: str
    storage: str
    logp_grad: Callable
    X0: jax.Array
    unwhiten: Optional[Callable] = None
    factor: object = None
    draw_bytes: int = 0
    gn: Optional[dict] = None
    rebuild: Optional[Callable] = None
    whiten64: Optional[Callable] = None


def _build_banded_gn_parts(model, data, dtype, R64, S64, anchor_X, anchor_th,
                           exact: bool = False):
    """(logp_grad, parts) with the GN factor, relative-energy zero point,
    and whitening all anchored at (X, theta) — the anchor can be refreshed
    mid-warmup (precond_refresh_steps).

    ``exact=False`` (storage='banded'): the target evaluates through the
    band-truncated factored operators; the relative-energy zero point is
    built from the SAME band-truncated factors.
    ``exact=True`` (storage='hybrid'): the target evaluates through the
    FULL dense operators (``data`` is the exact dense PosteriorData, R64/
    S64 are the untruncated factors); only the GN whitening factor — a
    preconditioner, not part of the target — is banded."""
    from magi_v2_tpu.ops.banded import (
        banded_diag_tile_inverses,
        banded_to_blocks_upper,
    )
    from magi_v2_tpu.posterior import make_ref_point
    from magi_v2_tpu.sampler.precond import (
        build_gn_cholesky_banded,
        make_tempered_logp_grad_gn_banded,
        make_tempered_logp_grad_gn_hybrid,
        whiten_X_banded,
    )

    with model._setup_device_ctx():
        # R64/S64 make Lambda the exact PSD GN curvature of the banded
        # target (raw band-truncated operators are indefinite at
        # dense-grid sizes — see precond.py); under exact=True they are
        # the untruncated factors and the build band-truncates them
        # internally (preconditioner quality only)
        U_band, gn_info = build_gn_cholesky_banded(
            model, C_inv_sqrts=R64, K_inv_sqrts=S64,
            at_X=anchor_X, at_thetas=anchor_th,
        )
        U_blocks64 = np.asarray(banded_to_blocks_upper(jnp.asarray(U_band)))
        # diagonal-tile inverses in f64: an in-graph f32 triangular solve
        # need not honor the matmul-precision pin (measured eps collapse —
        # see banded_diag_tile_inverses)
        U_dinv64 = np.asarray(
            banded_diag_tile_inverses(
                jnp.asarray(U_blocks64), model.mag_I * model.D
            )
        )
        # relative-energy zero point (f32 safety at dense-grid |lp| ~1e7 —
        # see posterior.RefPoint); built from the SAME operators the
        # target evaluates: band-truncated for 'banded', FULL for 'hybrid'
        # (masking there would re-introduce the truncation error the
        # hybrid exists to remove)
        if exact:
            m_ref = (
                model._exact_operators()[1]
                if model.BANDSIZE is not None else model.m_ds
            )
            R_ref, S_ref = R64, S64
        else:
            _i, _j = np.meshgrid(
                np.arange(model.mag_I), np.arange(model.mag_I),
                indexing="ij",
            )
            _bmask = np.abs(_i - _j) <= model.BANDSIZE
            R_ref = np.where(_bmask[None], R64, 0.0)
            S_ref = np.where(_bmask[None], S64, 0.0)
            m_ref = model.m_ds
        ref = make_ref_point(
            model.I, anchor_X, model.mu_ds, anchor_th, model.f_vec,
            R_ref, S_ref, m_ref, dtype,
        )
        # z0 = U (x_anchor - mu) in f64: the sampler works with the
        # whitened deviation z - z0
        z064 = np.asarray(
            whiten_X_banded(
                jnp.asarray(np.asarray(anchor_X, np.float64)),
                jnp.asarray(model.mu_ds),
                jnp.asarray(U_blocks64),
            )
        )
    U_blocks = jnp.asarray(U_blocks64, dtype)
    U_dinv = jnp.asarray(U_dinv64, dtype)
    z0 = jnp.asarray(z064.reshape(-1), dtype)
    maker = (
        make_tempered_logp_grad_gn_hybrid if exact
        else make_tempered_logp_grad_gn_banded
    )
    lp = maker(
        data, model.f_vec, U_blocks, model.mag_I, model.D,
        model.D_thetas, diag_inv=U_dinv, ref=ref, z0=z0,
    )
    def whiten64(Xn, _U=U_blocks64):
        with model._setup_device_ctx():
            return np.asarray(whiten_X_banded(
                jnp.asarray(np.asarray(Xn, np.float64)),
                jnp.asarray(model.mu_ds),
                jnp.asarray(_U),
            ))

    return lp, {
        "U_blocks": U_blocks, "U_dinv": U_dinv,
        "ref": ref, "z0": z0, "z064": z064, "info": gn_info,
        "whiten64": whiten64,
    }


def build_sampling_mode(
    model,
    data,
    reparam: str,
    storage: str,
    dtype,
    R64,
    S64,
    sig_pre_fix=None,
    anchor=None,
) -> SamplingMode:
    """Construct the SamplingMode for a fitted MAGI_v2 model.

    ``data`` is the (dense or banded) PosteriorData predict() built;
    ``R64``/``S64`` the f64 clamped sqrt factors of C^{-1}/K^{-1};
    ``sig_pre_fix`` the pre-space pinned sigma values (or None).

    ``anchor``: optional ``(X (N_I, D), thetas (D_thetas,))`` natural-
    coordinate point at which the banded/hybrid GN factor AND the
    relative-energy RefPoint are built, instead of the default
    ``(Xhat_init, thetas_init)``. A pure coordinate/zero-point change —
    the posterior is identical — but float32 accuracy at dense grids is
    NOT: the relative-energy form's f32 noise couples to the anchor's own
    residual magnitudes (|a0| = |C^{-1/2}(x0-mu)|, |s0|), which are ~1e3x
    smaller at the f64 MAP than at the spline init (the init's GP-prior
    quadratic is ~1e7 while the MAP's is ~1e3), and to the chains'
    whitened distance from the anchor, which stays bounded when chains
    START at the anchor's Laplace draws. Measured failure this fixes:
    Lorenz N_I=2049 (h^-4 operator scale ~1e12) with the init anchor is
    evaluation noise beyond the anchor's neighborhood — the tempered
    warmup drives chains there and eps collapses (frozen chains,
    results/lorenz2049_hybrid_probe.json; diagnosis
    results/stiffness_probe.json). Standard use:
    ``predict(gn_anchor=...)`` with ``map_estimate()``'s MAP.
    """
    itemsize = np.dtype(dtype).itemsize
    ND = model.mag_I * model.D

    def finish(mode: SamplingMode) -> SamplingMode:
        if sig_pre_fix is not None:
            mode.logp_grad = pin_sigma_coordinates(
                mode.logp_grad, jnp.asarray(sig_pre_fix, dtype),
                model.mag_I, model.D,
            )
        return mode

    if anchor is not None and not (
        reparam == "precond" and storage in ("banded", "hybrid")
    ):
        raise ValueError(
            "anchor= (predict gn_anchor=) is supported for the banded-GN "
            "modes only (reparam='precond', storage='banded'/'hybrid') — "
            f"got reparam={reparam!r}, storage={storage!r}"
        )

    if reparam == "precond" and storage in ("banded", "hybrid"):
        from magi_v2_tpu.sampler.precond import unwhiten_Z_banded

        exact = storage == "hybrid"
        anchor_X0, anchor_th0 = (
            (model.Xhat_init, model.thetas_init) if anchor is None
            else (np.asarray(anchor[0], np.float64),
                  np.asarray(anchor[1], np.float64))
        )
        logp_grad, gn = _build_banded_gn_parts(
            model, data, dtype, R64, S64, anchor_X0,
            anchor_th0, exact=exact,
        )
        nb, nw, T = (
            gn["U_blocks"].shape[0],
            gn["U_blocks"].shape[1],
            gn["U_blocks"].shape[2],
        )

        def rebuild(anchor_X, anchor_th):
            lp, parts = _build_banded_gn_parts(
                model, data, dtype, R64, S64, anchor_X, anchor_th,
                exact=exact,
            )
            return finish(replace(
                mode,
                logp_grad=lp,
                X0=jnp.asarray(parts["z064"], dtype),
                factor=(parts["U_blocks"], parts["U_dinv"]),
                gn=parts,
                whiten64=parts["whiten64"],
            ))

        mode = SamplingMode(
            reparam=reparam,
            storage=storage,
            logp_grad=logp_grad,
            X0=jnp.asarray(gn["z064"], dtype),
            unwhiten=lambda Z, mu, F: unwhiten_Z_banded(
                Z, mu, F[0], diag_inv=F[1]
            ),
            factor=(gn["U_blocks"], gn["U_dinv"]),
            # the block-banded matvec materializes an (nb, nw, T) window
            # stack — nw copies of the input — plus in/out vectors
            draw_bytes=(nb * nw * T + 2 * ND) * itemsize,
            gn=gn,
            rebuild=rebuild,
            whiten64=gn["whiten64"],
        )
        return finish(mode)

    if reparam == "precond":
        if dtype == jnp.float32 and model.mag_I >= 768:
            import warnings

            warnings.warn(
                "storage='dense' with reparam='precond' in float32 "
                "measured a step-size collapse at N_I ~ 1k (a "
                "high-gradient curvature cliff the GN linearization "
                "misses at this scale); use storage='banded' (the "
                "large-grid mode, requires bandsize) — measured "
                "healthy eps 2.9e-2 at Lorenz N_I=1025.",
                stacklevel=3,
            )
        # full-state Gauss-Newton whitening; factors built host-side in
        # float64 (float32 eigh of the stiff precision is unreliable),
        # then cast to the sampling dtype
        from magi_v2_tpu.posterior import make_ref_point
        from magi_v2_tpu.sampler.precond import (
            build_gn_whitening,
            make_tempered_logp_grad_gn,
            unwhiten_Z_full,
            whiten_X_full,
        )

        with model._setup_device_ctx():
            # R64/S64: A1 = L'(R'R)L matches the factored t1 the dense
            # target evaluates, and keeps Lambda PSD under band truncation
            # (see precond.py)
            L64, L_inv64, A164 = build_gn_whitening(
                model, sigma_sqs_init=None,
                C_inv_sqrts=R64, K_inv_sqrts=S64,
            )
            # relative-energy zero point (f32 safety at dense-grid |lp|
            # ~1e7 — see posterior.RefPoint)
            ref = make_ref_point(
                model.I, model.Xhat_init, model.mu_ds, model.thetas_init,
                model.f_vec, R64, S64, model.m_ds, dtype,
            )
            z064 = np.asarray(
                whiten_X_full(
                    jnp.asarray(np.asarray(model.Xhat_init, np.float64)),
                    jnp.asarray(np.asarray(model.mu_ds, np.float64)),
                    jnp.asarray(np.asarray(L_inv64)),
                )
            )
        L = jnp.asarray(np.asarray(L64), dtype)
        A1 = jnp.asarray(np.asarray(A164), dtype)
        z0 = jnp.asarray(z064.reshape(-1), dtype)
        logp_grad = make_tempered_logp_grad_gn(
            data, model.f_vec, L, A1, model.mag_I, model.D,
            model.D_thetas, ref=ref, z0=z0,
        )
        def whiten64_full(Xn, _Li=np.asarray(L_inv64)):
            with model._setup_device_ctx():
                return np.asarray(whiten_X_full(
                    jnp.asarray(np.asarray(Xn, np.float64)),
                    jnp.asarray(np.asarray(model.mu_ds, np.float64)),
                    jnp.asarray(_Li),
                ))

        return finish(SamplingMode(
            reparam=reparam,
            storage=storage,
            logp_grad=logp_grad,
            X0=jnp.asarray(z064, dtype),
            unwhiten=lambda Z, mu, F: unwhiten_Z_full(Z, mu, F),
            factor=L,
            draw_bytes=3 * ND * itemsize,
            whiten64=whiten64_full,
        ))

    if reparam == "whitened":
        from magi_v2_tpu.sampler.magi_state import (
            gp_sqrt_factors,
            make_tempered_logp_grad_whitened,
            unwhiten_Z,
            whiten_X,
        )

        with model._setup_device_ctx():
            L64, L_inv64 = gp_sqrt_factors(jnp.asarray(model.C_d_invs))
        L = jnp.asarray(np.asarray(L64), dtype)
        L_inv = jnp.asarray(np.asarray(L_inv64), dtype)
        logp_grad = make_tempered_logp_grad_whitened(
            data, model.f_vec, L, model.mag_I, model.D, model.D_thetas
        )
        def whiten64_gp(Xn, _Li=np.asarray(L_inv64)):
            with model._setup_device_ctx():
                return np.asarray(whiten_X(
                    jnp.asarray(np.asarray(Xn, np.float64)),
                    jnp.asarray(np.asarray(model.mu_ds, np.float64)),
                    jnp.asarray(_Li),
                ))

        # f64 whitening then cast, like the GN modes (an f32 whiten here
        # measured ~1e-4 coordinate noise vs the f64 map)
        X0 = jnp.asarray(whiten64_gp(model.Xhat_init), dtype)

        return finish(SamplingMode(
            reparam=reparam,
            storage=storage,
            logp_grad=logp_grad,
            X0=X0,
            unwhiten=lambda Z, mu, F: unwhiten_Z(Z, mu, F),
            factor=L,
            draw_bytes=3 * ND * itemsize,
            whiten64=whiten64_gp,
        ))

    if reparam == "centered":
        from magi_v2_tpu.sampler.magi_state import make_tempered_logp_grad

        logp_grad = make_tempered_logp_grad(
            data, model.f_vec, model.mag_I, model.D, model.D_thetas
        )
        return finish(SamplingMode(
            reparam=reparam,
            storage=storage,
            logp_grad=logp_grad,
            X0=jnp.asarray(model.Xhat_init, dtype),
            whiten64=lambda Xn: np.asarray(Xn, np.float64),
        ))

    raise ValueError(f"unknown reparam mode {reparam!r}")


def apply_init_states(q0, init_states, mode, model, sigma_sqs_LB,
                      sigma_sqs_fixed):
    """Overwrite per-chain initial-state blocks of ``q0`` from
    NATURAL-coordinate user values (predict(init_states=...)).

    ``init_states`` keys (each optional; a missing key keeps the default
    heuristic init for that block):

    - ``"X"``: trajectories, shape (num_chains, N_I, D) or (N_I, D)
      (broadcast to all chains). Mapped into the mode's sampling
      coordinates through the SAME float64 whitening that built
      ``mode.X0``.
    - ``"thetas"``: (num_chains, D_thetas) or (D_thetas,), natural scale
      (>= 0 enforced by the same inverse-softplus floor as the default
      init).
    - ``"sigma_sqs"``: (num_chains, D) or (D,) observation-noise
      VARIANCES; rejected when ``sigma_sqs_fixed`` pins sigma.

    Standard use: overdispersed or Laplace-scattered chain starts —
    e.g. draws from ``MAGI_v2.map_estimate()``'s Laplace approximation,
    the measured fix for slow unobserved-component mixing under
    ``reparam='centered'`` (Hes1 H, DEVIATIONS.md #23). The
    checkpoint fingerprint hashes q0, so changed inits never silently
    resume an old run. No reference counterpart (the reference is
    single-chain from one heuristic init, magi_v2.py:374-383).

    Returns ``q0`` (modified in place; (num_chains, N_I*D + D + D_thetas)
    numpy in the sampling dtype).
    """
    from magi_v2_tpu.posterior import softplus_inverse

    unknown = set(init_states) - {"X", "thetas", "sigma_sqs"}
    if unknown:
        raise ValueError(
            f"init_states has unknown keys {sorted(unknown)}; expected a "
            "subset of {'X', 'thetas', 'sigma_sqs'}"
        )
    num_chains = q0.shape[0]
    N, D, Dth = model.mag_I, model.D, model.D_thetas

    def per_chain(name, arr, shape):
        arr = np.asarray(arr, np.float64)
        if arr.shape == shape:
            arr = np.broadcast_to(arr, (num_chains,) + shape)
        if arr.shape != (num_chains,) + shape:
            raise ValueError(
                f"init_states[{name!r}] has shape {arr.shape}; expected "
                f"{(num_chains,) + shape} or {shape}"
            )
        if np.any(np.isnan(arr)):
            raise ValueError(f"init_states[{name!r}] contains NaNs")
        return arr

    # inverse-softplus where above the bound, else the default -5.0 floor
    # (same map as predict()'s heuristic init, magi_v2.py:374-383)
    def pre(vals, lower):
        out = np.full_like(vals, -5.0)
        above = vals > lower
        if above.any():
            out[above] = np.asarray(
                softplus_inverse(jnp.asarray(vals[above] - lower[above]))
            )
        return out

    if "X" in init_states:
        if mode.whiten64 is None:
            raise ValueError(
                f"init_states['X'] is not supported for reparam="
                f"{mode.reparam!r} (no whitening map)"
            )
        Xi = per_chain("X", init_states["X"], (N, D))
        Z = np.stack([
            np.asarray(mode.whiten64(Xi[c]), np.float64)
            for c in range(num_chains)
        ])
        q0[:, : N * D] = Z.reshape(num_chains, N * D)
    if "sigma_sqs" in init_states:
        if sigma_sqs_fixed is not None:
            raise ValueError(
                "init_states['sigma_sqs'] conflicts with sigma_sqs_fixed "
                "(sigma coordinates are pinned)"
            )
        ss = per_chain("sigma_sqs", init_states["sigma_sqs"], (D,))
        lb = np.broadcast_to(np.asarray(sigma_sqs_LB, np.float64), (D,))
        q0[:, N * D : N * D + D] = np.stack(
            [pre(ss[c], lb) for c in range(num_chains)]
        )
    if "thetas" in init_states:
        th = per_chain("thetas", init_states["thetas"], (Dth,))
        zero = np.zeros((Dth,), np.float64)
        q0[:, N * D + D :] = np.stack(
            [pre(th[c], zero) for c in range(num_chains)]
        )
    return q0


def refresh_gn_anchor(
    mode: SamplingMode,
    model,
    q0,
    num_chains: int,
    sampler_config,
    dtype,
    seed: int,
    precond_refresh_steps: int,
    verbose: bool = False,
    restart: str = "remap",
    restart_scatter: float = 0.1,
):
    """Stage A + re-anchor for the banded GN mode (precond_refresh_steps).

    Runs a short warmup to move the ensemble off the init, then re-anchors
    the GN factor, zero point, and whitening at the chain-median state —
    the fixed-point linearization goes stale as chains travel (measured:
    Lorenz N_I=1025 untempered eps collapses to ~1e-6 with the
    init-anchored factor while the tempered run at the same factor holds
    eps 2.9e-2). Returns (refreshed mode, new chain states).

    ``restart`` picks the stage-B initialization:

    - "remap": carry each chain's stage-A state into the refreshed
      coordinates (exact linear remap). Correct, but when stage A ran hot
      (tempered), the ensemble is hugely dispersed — measured Lorenz
      N_I=1025: relative-lp spread ~1e5 across chains, so stage B starts
      most chains outside the anchor's linearization basin and they
      diverge (31% divergence rate, acceptance 0.07, R-hat 4.8).
    - "laplace": restart every chain from a SCALED Gauss-Newton Laplace
      draw at the refreshed anchor — z = z0 + restart_scatter * N(0, I)
      in the whitened coordinates, theta at the anchor + jitter, sigma
      carried from stage A. ``restart_scatter`` must be well below 1:
      a unit scatter puts every chain at whitened radius ~sqrt(ND) from
      the anchor, which is the Laplace approximation's typical set but
      NOT the true posterior's at dense-grid scale — measured Lorenz
      N_I=1025 (ND=3075): unit scatter gives a 3200-nat lp spread across
      chains (typical-set spread would be ~80), 91% divergence rate,
      acceptance 0.017, R-hat 198.

    STATUS — experimental, measured HARMFUL at dense-grid scale. Every
    restart mode fails the Lorenz N_I=1025 x 256-chain acceptance config
    (DEVIATIONS.md #22):

    - remap: 31% divergence, R-hat 4.8 (dispersed tempered ensemble
      outside the refreshed linearization basin, as documented above);
    - laplace scatter=1.0: 91% divergence, R-hat 198;
    - laplace scatter=0.1: 89% divergence from the FIRST stage-B draw
      (98.7% in block 0), R-hat 166, even though the stage-B warmup ran
      1500 more adaptation steps. Mechanism: chains restart CLUSTERED at
      the anchor, early adaptation sees near-mode geometry and pushes eps
      up; as the ensemble re-disperses the target hardens, the eps
      trajectory falls, and the dual-averaging AVERAGE (what stage B
      freezes, per Hoffman-Gelman) lags above the final adapted value —
      frozen eps 0.046 vs the 0.029 the no-refresh run adapts to, past
      the divergence cliff.

    The supported dense-grid recipe is NO refresh: init-anchored banded
    GN whitening sampling the TEMPERED (reference-schedule) target with a
    pinned floor (anneal_mode='reference'; measured eps 2.9e-2, acceptance
    0.60, divergence 1.6e-4). The beta=1 target itself is eps-collapsed at
    this scale for ANY fixed metric — measured frozen-eps ladder: 3.9e-4
    at b=100, 7.1e-6 at b=200 (wider bands restore more of the true h^-4
    manifold stiffness), acceptance UNIFORM across chains, i.e. a global
    property of the dense-grid MAGI posterior, not an adaptation artifact.
    See scripts/lorenz1025_long.py and DEVIATIONS.md.
    """
    import time

    from magi_v2_tpu.ops.banded import block_banded_matvec_upper
    from magi_v2_tpu.posterior import softplus as _sp
    from magi_v2_tpu.sampler.precond import unwhiten_Z_banded
    from magi_v2_tpu.sampler.run import run_nuts_chains

    if mode.rebuild is None:
        raise ValueError(
            "precond_refresh_steps requires reparam='precond' and "
            "storage='banded' (the mode whose linearization goes stale "
            "at dense-grid scale)"
        )
    warnings.warn(
        "precond_refresh_steps is experimental and measured HARMFUL at "
        "dense-grid scale (Lorenz N_I=1025 x 256 chains: 31-91% divergence "
        "across all restart modes; see refresh_gn_anchor docstring). The "
        "supported large-grid recipe is no refresh: init-anchored banded "
        "GN sampling the tempered (anneal_mode='reference') target.",
        stacklevel=2,
    )
    gn = mode.gn
    U_blocks, U_dinv = gn["U_blocks"], gn["U_dinv"]
    cfg_a = sampler_config._replace(
        num_results=1, num_burnin_steps=precond_refresh_steps,
        progress_every=0, thin=1,
        # stage A gets its own checkpoint namespace: it is a different
        # step sequence from the main run (the fingerprint would reject
        # a shared directory anyway)
        checkpoint_path=(
            os.path.join(sampler_config.checkpoint_path, "stageA")
            if sampler_config.checkpoint_path else ""
        ),
    )
    start = time.time()
    samples_a, _ = run_nuts_chains(
        mode.logp_grad, jnp.asarray(q0, dtype),
        jax.random.PRNGKey(seed + 1000), cfg_a,
    )
    qs_a = jax.block_until_ready(samples_a)[-1]       # (C, dim)
    ND = model.mag_I * model.D
    with jax.default_matmul_precision("highest"):
        # x = x0 + U_old^{-1}(z - z0_old): the f32-accurate relative map
        # (the absolute mu + U^{-1} z form loses the deviation at scale)
        dz = qs_a[:, :ND] - gn["z0"][None, :]
        Xc_chains = unwhiten_Z_banded(
            dz.reshape(num_chains, model.mag_I, model.D),
            jnp.zeros((model.D,), dtype),
            U_blocks, diag_inv=U_dinv,
        )
    X_chains = np.asarray(Xc_chains) + np.asarray(gn["ref"].x0)[None]
    anchor_X = np.median(np.asarray(X_chains, np.float64), axis=0)
    anchor_th = np.asarray(
        _sp(qs_a[:, ND + model.D:]).mean(axis=0), np.float64
    )
    if verbose:
        print(
            f"[precond_refresh] re-anchored after "
            f"{precond_refresh_steps} steps in {time.time()-start:.0f}s; "
            f"theta anchor {np.round(anchor_th, 3)}"
        )
    mode = mode.rebuild(anchor_X, anchor_th)
    if restart == "laplace":
        # restart at the GN Laplace approximation of the refreshed anchor:
        # whitened curvature is I by construction, so z0 + N(0, I) samples
        # the local Gaussian posterior over X (theta/sigma held near the
        # anchor) — every chain starts inside the linearization basin
        from magi_v2_tpu.posterior import softplus_inverse

        rng = np.random.default_rng(seed + 2000)
        z_new = np.asarray(mode.gn["z064"], np.float64).reshape(-1)[None, :]
        z_new = z_new + restart_scatter * rng.standard_normal(
            (num_chains, ND)
        )
        th_pre = np.asarray(
            softplus_inverse(jnp.asarray(anchor_th))
        )[None, :] + 0.05 * rng.standard_normal(
            (num_chains, model.D_thetas)
        )
        sig_pre = np.asarray(qs_a[:, ND : ND + model.D], np.float64)
        q0 = np.concatenate([z_new, sig_pre, th_pre], axis=1)
    elif restart == "remap":
        # remap chains into the refreshed coordinates:
        # z_new = z0_new + U_new (x - x_anchor)  — the deviation form
        # keeps f32 accuracy (x - x_anchor is small)
        delta_flat = (
            jnp.asarray(X_chains, dtype) - jnp.asarray(anchor_X, dtype)[None]
        ).reshape(num_chains, -1)
        with jax.default_matmul_precision("highest"):
            z_new = mode.gn["z0"][None, :] + block_banded_matvec_upper(
                mode.gn["U_blocks"], delta_flat
            )
        q0 = np.concatenate(
            [np.asarray(z_new), np.asarray(qs_a[:, ND:])], axis=1
        )
    else:
        raise ValueError(f"unknown refresh restart mode {restart!r}")
    if verbose:
        with jax.default_matmul_precision("highest"):
            _lps = jax.vmap(
                lambda q: mode.logp_grad(q, jnp.asarray(1.0, dtype))[0]
            )(jnp.asarray(q0[:4], dtype))
        print(
            f"[precond_refresh] lp at remapped chains[:4]: "
            f"{np.round(np.asarray(_lps), 2)}"
        )
    return mode, q0


def unwhiten_draws(mode: SamplingMode, X_samps, mu_ds, num_chains, dtype):
    """Map z draws (T, C, N_I, D) back to trajectories X = mu + W z.
    No-op for the centered mode.

    Device-resident draws (the sampler kept them on device, run.py
    stage_above_bytes) up to 1 GiB unwhiten on device in batched chunks;
    larger or host-staged draws go through the staged path, which feeds
    the device chunk by chunk and runs each chunk's draws through a
    sequential lax.map, so device memory holds ONE draw's matvec working
    set (the window stack) regardless of chunk size."""
    if mode.unwhiten is None:
        return X_samps
    device_resident = isinstance(X_samps, jax.Array)
    if device_resident and X_samps.nbytes > (1 << 30):
        # full array + matvec intermediates co-resident is the measured
        # OOM mode at Lorenz size — spill to the host-staged chunk path
        device_resident = False
    with jax.default_matmul_precision("highest"):
        factor, mu = mode.factor, mu_ds
        # the factor is passed as an argument, NOT closed over: a closure
        # bakes it into the executable as a constant
        f_unw = jax.jit(
            lambda Z, mu, F: jax.lax.map(
                lambda z: mode.unwhiten(z[None], mu, F)[0], Z
            )
        )
        # chunk draws to bound the work of one dispatch (~5e11 flops);
        # memory is per-draw thanks to the lax.map, but keep a guard so a
        # single draw's window stack fits comfortably
        factor_size = sum(f.size for f in jax.tree.leaves(mode.factor))
        chunk = max(1, int(5e11 // max(1, 2 * num_chains * factor_size)))
        if num_chains * mode.draw_bytes > int(4e9):
            raise MemoryError(
                "one draw's unwhitening working set exceeds the device "
                f"budget ({num_chains} chains x {mode.draw_bytes} B); "
                "reduce num_chains or bandsize"
            )
        if device_resident:
            # draws fit on device — dispatch whole chunks as ONE batched
            # matvec so the device sees a large batch (the per-draw
            # lax.map of the staged path leaves it idle). Chunks are
            # bounded by dispatch flops (above) AND intermediate memory
            # (num_chains * draw_bytes per draw, ~2 GB budget).
            mem_chunk = int(2e9) // max(1, num_chains * mode.draw_bytes)
            dchunk = max(1, min(chunk, mem_chunk))
            f_batch = jax.jit(lambda Z, m, F: mode.unwhiten(Z, m, F))
            outs = [
                f_batch(X_samps[i : i + dchunk], mu, factor)
                for i in range(0, X_samps.shape[0], dchunk)
            ]
            return outs[0] if len(outs) == 1 else jnp.concatenate(outs, 0)
        # stage the z draws on host: keeping the full (T, C, ND) array on
        # device alongside the matvec intermediates is what blew the
        # memory budget
        X_samps = np.asarray(X_samps)
        return np.concatenate(
            [
                np.asarray(f_unw(jnp.asarray(X_samps[i : i + chunk]),
                                  mu, factor))
                for i in range(0, X_samps.shape[0], chunk)
            ],
            axis=0,
        )
