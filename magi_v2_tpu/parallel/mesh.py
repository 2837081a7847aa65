"""Multi-chip scale-out: shard MCMC chains across a device mesh.

The reference has no multi-device code at all (single process, single CPU
device, single chain — magi_v2.py:287,383; SURVEY.md §2). The scale-out
for MAGI is data-parallel over *chains*: chains are embarrassingly
parallel, so we lay the vmapped chain axis over a 1-D ``chains`` mesh axis
with jax.sharding and let XLA partition the whole warmup+sampling scan —
collectives only appear where cross-chain statistics are pooled (the mean
acceptance probability for dual averaging and the Welford mass-matrix
moments), and those are tiny all-reduces that XLA hands to NCCL over the
NVLink that joins the GPUs of one host all to all.

No hand-written communication backend is needed: the SPMD partitioner
inserts the collectives from the input sharding alone (SURVEY.md §2
"Collective comm backend" row).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from magi_v2_tpu.sampler.run import SamplerConfig, run_nuts_chains


def chain_mesh(devices=None) -> Mesh:
    """A 1-D mesh with a ``chains`` axis over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), axis_names=("chains",))


def shard_chain_states(q0: jax.Array, mesh: Mesh) -> jax.Array:
    """Place (C, dim) chain states with the chain axis split over the mesh.

    C must be a multiple of the mesh size.
    """
    sharding = NamedSharding(mesh, P("chains", None))
    return jax.device_put(q0, sharding)


def run_nuts_chains_sharded(
    tempered_logp_grad,
    q0: jax.Array,
    key: jax.Array,
    config: SamplerConfig = SamplerConfig(),
    mesh: Mesh | None = None,
):
    """run_nuts_chains with the chain axis sharded over a device mesh.

    The sampler body is identical — XLA's SPMD partitioner splits the
    vmapped NUTS across devices from the input sharding alone and inserts
    the (tiny) all-reduces for the pooled adaptation statistics. Returns
    (samples (T, C, dim) chain-sharded, ChainStats).
    """
    if mesh is None:
        mesh = chain_mesh()
    if q0.shape[0] % mesh.size != 0:
        raise ValueError(
            f"num chains {q0.shape[0]} must be a multiple of mesh size {mesh.size}"
        )
    # Input sharding alone drives XLA's SPMD partitioner; the jit inside
    # run_nuts_chains propagates it through both scans.
    q0 = shard_chain_states(q0, mesh)
    return run_nuts_chains(tempered_logp_grad, q0, key, config)
