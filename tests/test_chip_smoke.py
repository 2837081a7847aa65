"""chip_smoke.py's pieces on the CPU at tiny sizes, the compile-cache
helper and bench.py's peak table. The same phases run at real widths on
the GPU (``-m gpu`` tests at the end, and ``python chip_smoke.py``)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke as cs
from magi_v2_tpu.utils import compile_cache


@pytest.fixture(scope="module")
def seir_model():
    return cs.fit_seir(jnp.float32, n_obs=21)


# ---------------------------------------------------------------------------
# compile cache, peaks, device check
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env_dir", ["/somewhere/else/jax_cache", None])
def test_compile_cache_dir(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins (and no other directory is set in
    code); otherwise the fixed in-checkout .jax_cache, which git ignores."""
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        expected = os.path.join(compile_cache.CHECKOUT_ROOT, ".jax_cache")
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env_dir)
        expected = env_dir
    try:
        assert compile_cache.compile_cache_dir() == expected
        assert compile_cache.enable_compile_cache() == expected
        if env_dir is None:
            assert jax.config.jax_compilation_cache_dir == expected
            with open(os.path.join(compile_cache.CHECKOUT_ROOT,
                                   ".gitignore")) as fh:
                assert ".jax_cache/" in fh.read().split()
        else:
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("kind,known", [("NVIDIA H100 80GB HBM3", True),
                                        ("NVIDIA A100-SXM4-80GB", False)])
def test_peak_table(kind, known):
    if known:
        p = bench.peaks_for(kind)
        assert (p["fp32_flops"], p["tf32_flops"], p["bf16_flops"],
                p["hbm_bytes_per_s"]) == (67e12, 495e12, 989e12, 3.35e12)
    else:
        with pytest.raises(ValueError, match="no published peaks"):
            bench.peaks_for(kind)


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.require_gpu(jax)


def test_require_gpu_rejects_platforms_without_cpu(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    with pytest.raises(RuntimeError, match="CPU backend"):
        cs.require_gpu(jax)


def test_device_time_is_none_without_gpu_plane():
    f = jax.jit(lambda x: x * 2.0)
    assert cs.device_time_ms(jax, f, (jnp.ones(4),), reps=1) is None


# ---------------------------------------------------------------------------
# phase 1 parity at tiny widths (every gated check must pass on the CPU)
# ---------------------------------------------------------------------------

def _gated_ok(rec):
    return all(v["ok"] for v in rec.values()
               if isinstance(v, dict) and "ok" in v)


def test_parity_bessel_tiny():
    failures = []
    rec = cs.parity_bessel(jax, 256, failures, time_ops=False)
    assert failures == [] and _gated_ok(rec)


@pytest.mark.parametrize("n_i,t_max,phi", [(41, 4.0, (0.5, 0.5)),
                                           (65, 2.0, (100.0, 0.2))])
def test_parity_kernel_matrices_tiny(n_i, t_max, phi):
    failures = []
    rec = cs.parity_kernel_matrices(jax, n_i, t_max, *phi, (1e-10, 1e-10),
                                    failures, time_ops=False)
    assert failures == [] and _gated_ok(rec)


def test_parity_log_posterior_tiny(seir_model):
    model, _ = seir_model
    failures = []
    rec = cs.parity_log_posterior(jax, model, failures, n_chains=4,
                                  time_ops=False)
    assert failures == [] and _gated_ok(rec)


def test_parity_banded_tiny():
    failures = []
    rec = cs.parity_banded(jax, failures, n=150, d=3, b=20, n_chains=4,
                           time_ops=False)
    assert failures == [] and _gated_ok(rec)


# ---------------------------------------------------------------------------
# phases 2-5 at tiny sizes
# ---------------------------------------------------------------------------

def test_seir_phase_tiny(seir_model):
    """Runs 1-3 complete; at 20 steps only the statistical gates (theta
    off truth, R-hat) may fail."""
    model, setup_s = seir_model
    failures = []
    out = cs.phase_seir(jax, model, setup_s, failures, num_chains=4,
                        steps=20, nuts_chains=2, nuts_steps=10,
                        warm_rerun=False)
    assert all("theta off truth" in f or "rhat" in f for f in failures)
    assert out["run2_nuts_f64_defaults"]["progress_lines"] > 0
    assert np.all(np.isfinite(out["run3_map_estimate"]["theta_map"]))
    assert len(out["run1_bench_recipe_f32"]["theta_mean"]) == 3


def test_gpu_setup_phase_tiny(seir_model):
    """On the CPU this compares the CPU setup with itself (setup_on_cpu
    False vs True): well inside the phase's tolerance."""
    model, _ = seir_model
    failures = []
    out = cs.phase_gpu_setup(jax, model, failures, n_obs=21)
    assert failures == []
    assert out["thetas_init"]["rel_err"] <= cs.SETUP_RTOL


def test_dense_grid_phase_tiny():
    failures = []
    out = cs.phase_dense_grid(jax, failures, n_obs=17, disc=1, bandsize=8,
                              num_chains=4, burnin=10, results=10,
                              leapfrogs=4)
    assert failures == []
    assert out["draws_finite"] and out["hybrid_f64_vs_numpy"]["ok"]
    assert out["hybrid_f64_vs_centered"]["ok"]
    assert out["hybrid_f32_vs_f64"]["ok"]


def test_four_device_phase_on_virtual_cpus():
    failures = []
    out = cs.phase_four_gpus(jax, failures, n_dev=4, num_chains=8, steps=10,
                             n_obs=21)
    assert failures == []
    assert out["f64_4x4"]["frac_chains_within_1e-6"] == 1.0


# ---------------------------------------------------------------------------
# the same phases at real widths, on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_parity_real_widths_on_gpu(gpu_device):
    model, _ = cs.fit_seir(jnp.float32)
    failures = []
    with jax.default_device(gpu_device):
        recs = cs.phase_parity(jax, model, failures, time_ops=False)
    print(json.dumps(recs, default=cs._num))
    assert failures == []


@pytest.mark.gpu
def test_dense_grid_on_gpu(gpu_device):
    failures = []
    with jax.default_device(gpu_device):
        out = cs.phase_dense_grid(jax, failures)
    print(json.dumps(out, default=cs._num))
    assert failures == [] and out["draws_finite"]
