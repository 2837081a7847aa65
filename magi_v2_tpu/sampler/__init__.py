"""Multi-chain MCMC for MAGI: iterative NUTS under jit/vmap, dual-averaging
step-size adaptation, pooled diagonal mass-matrix warmup, and in-graph
logarithmic temperature annealing.

Replaces the reference's tfp.mcmc stack (magi_v2.py:360-396,838-889) with a
one-jit design: the whole chain loop is one lax.scan inside one jit; the
annealing step counter is threaded through the scan carry (the reference
mutates a tf.Variable from inside jit — the crash recorded in its committed
notebooks, SURVEY.md §4); chains vmap over a leading axis and shard over
device meshes.
"""

from magi_v2_tpu.sampler.nuts import NutsConfig, nuts_step
from magi_v2_tpu.sampler.run import (
    SamplerConfig,
    log_temperature_schedule,
    run_nuts_chains,
)

__all__ = [
    "NutsConfig",
    "nuts_step",
    "SamplerConfig",
    "log_temperature_schedule",
    "run_nuts_chains",
]
