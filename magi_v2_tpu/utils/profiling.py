"""Tracing / profiling / observability.

The reference's only instrumentation is a wall-clock pair around sampling
(magi_v2.py:402-409) and tqdm bars. Here (SURVEY.md §5 rebuild items):
per-phase timers, a jax.profiler trace context for device timelines, and a
structured sampler report (acceptance / divergences / step size / tree
depths / ESS / R-hat)."""

from __future__ import annotations

import contextlib
import json
import time

import numpy as np


class PhaseTimer:
    """Accumulates named phase wall-times; print or export as dict."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.time() - t0

    def report(self) -> dict:
        total = sum(self.phases.values())
        return {**{k: round(v, 3) for k, v in self.phases.items()},
                "total_s": round(total, 3)}

    def __repr__(self):
        return f"PhaseTimer({json.dumps(self.report())})"


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace context — view with TensorBoard/XProf.

    Usage:
        with device_trace("/tmp/magi-trace"):
            model.predict(...)
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def sampler_report(results: dict, wall_seconds: float | None = None) -> dict:
    """Structured diagnostics from a predict() results dict."""
    from magi_v2_tpu.utils.diagnostics import summarize_chains

    kr = results["kernel_results"]
    theta = np.asarray(results["thetas_samps"])
    if theta.ndim == 2:
        theta = theta[:, None, :]
    summary = summarize_chains(theta, wall_seconds)
    return {
        "step_size": float(np.asarray(kr["step_size"])),
        "mean_accept_prob": float(np.asarray(kr["accept_probs"]).mean()),
        "divergence_rate": float(np.asarray(kr["divergences"]).mean()),
        "mean_tree_depth": float(np.asarray(kr["depths"]).mean()),
        "mean_leapfrogs_per_step": float(np.asarray(kr["num_leapfrogs"]).mean()),
        **summary,
    }
