"""Configuration for magi_v2_tpu.

The reference hard-codes every tunable (Matern nu=2.01 at magi_v2.py:125,
Adam lr/iters at magi_v2.py:161,230,654, NUTS step_size/target_accept at
magi_v2.py:364-366, anneal min_temp at magi_v2.py:841, sigma^2 lower-bound
heuristic at magi_v2.py:300). Here they are all lifted into one dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp


def enable_x64() -> None:
    """Enable float64 in JAX (parity mode with the float64 reference)."""
    jax.config.update("jax_enable_x64", True)


@dataclasses.dataclass(frozen=True)
class MagiConfig:
    """All tunables of the MAGI pipeline in one place.

    Defaults replicate the reference's hard-coded values (citations inline).
    """

    # Matern smoothness. Reference: v=2.01 everywhere (magi_v2.py:125,265,448).
    matern_nu: float = 2.01

    # --- hyperparameter MLE (reference magi_v2.py:538-691) ---
    hparam_learning_rate: float = 0.01   # magi_v2.py:654
    hparam_num_iters: int = 1000         # magi_v2.py:654
    # "adam" (reference parity, magi_v2.py:654) or "lbfgs" (jitted
    # on-device L-BFGS, ops/lbfgs.py — the BASELINE.json north-star path;
    # measured: 18 iters to a marginally lower MAP than Adam-1000). Both
    # run as ONE device dispatch.
    hparam_optimizer: str = "adam"
    # Where to evaluate the GP marginal likelihood: "obs" fits on the raw
    # observations at observation times (statistically sound: recovers the
    # true noise level); "grid" fits on linearly interpolated values over
    # the full discretization grid like the reference (magi_v2.py:105-106)
    # — which drives sigma^2 toward 0 (interpolated points are locally
    # collinear, so the GP absorbs the noise) and biases phi2 low, which in
    # turn biases theta. See DEVIATIONS.md item 14.
    hparam_fit_points: str = "obs"

    # --- theta / X_unobs initialization (reference magi_v2.py:133-268) ---
    init_learning_rate: float = 0.01     # magi_v2.py:161,230
    init_num_iters: int = 10000          # magi_v2.py:161,230

    # --- sampler (reference magi_v2.py:360-371) ---
    initial_step_size: float = 0.1       # magi_v2.py:364
    target_accept: float = 0.75          # magi_v2.py:366
    adaptation_fraction: float = 0.8     # magi_v2.py:365 (0.8 * burnin)
    max_tree_depth: int = 10             # TFP NoUTurnSampler default
    # Temperature anneal (reference magi_v2.py:833-835,841).
    anneal_min_temp: float = 0.1
    # Mass-matrix adaptation: the reference uses an identity mass matrix.
    # Diagonal adaptation (Welford during warmup) is a strict improvement and
    # is on by default; set False for closest reference parity.
    adapt_mass_matrix: bool = True

    # Run initial_fit's device work (hyperparameter MLE, theta init, kernel
    # matrices + pinv) on the host CPU backend, in float64 (scoped x64).
    # The setup is small but precision-critical: float32 pinv corrupts the
    # precision operators, and native CPU float64 is both correct and fast
    # at these sizes. Sampling still runs on the default backend (the GPU)
    # in MagiConfig.dtype. With False, setup runs on the default backend
    # in whatever precision the global x64 flag gives; chip_smoke.py
    # phase 3 compares the two in f64 on the GPU.
    setup_on_cpu: bool = True

    # --- numerics ---
    # Parity mode is float64 (the reference is float64 end to end,
    # magi_v2.py:89,136,226-227). float32 is the fast sampling mode.
    dtype: jnp.dtype = jnp.float64
    # Diagonal jitter added to the GP covariance before Cholesky in the
    # hyperparameter MLE; 1e-6 mirrors the TFP GaussianProcess default the
    # reference relies on (magi_v2.py:594-597).
    cholesky_jitter: float = 1e-6

    # --- preprocessing ---
    spline_cv_folds: int = 5             # magi_v2.py:715
    spline_obs_per_knot: int = 10        # magi_v2.py:718
    spline_min_points: int = 10          # magi_v2.py:699

    # sigma^2 lower-bound heuristic multiplier (magi_v2.py:300).
    sigma_sq_lb_scale: float = 0.01

    def replace(self, **kwargs) -> "MagiConfig":
        return dataclasses.replace(self, **kwargs)


DEFAULT_CONFIG = MagiConfig()
