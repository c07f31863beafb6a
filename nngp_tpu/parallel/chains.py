"""shard_map'd chain execution over a device mesh.

Chains = data parallelism of MCMC (SURVEY.md §2c): the per-cycle update is
embarrassingly parallel across chains; each device runs a vmapped block of
local chains, and only small per-chain scalars ever cross devices (in the
collective diagnostics).  The problem structure (graph, data) is replicated
— it is read-only and shared, exactly like the reference's forked memory
pages.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nngp_tpu.models.gaussian import run_cycle

CHAINS_AXIS = "chains"


def chains_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices with a 'chains' axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (CHAINS_AXIS,))


def make_sharded_cycle_fn(graph, data, cfg, mesh: Mesh):
    """Jitted cycle update with chains sharded over ``mesh``.

    states/keys carry a leading chains axis divisible by the mesh size;
    each device vmaps over its local chains.  Records come back sharded the
    same way (device-local until the host gathers them).
    """

    import jax.numpy as jnp

    def local_cycle(graph_, data_, states, keys, iter_start, slots):
        return jax.vmap(
            lambda s, k: run_cycle(graph_, data_, cfg, s, k, iter_start,
                                   saved_slots=slots)
        )(states, keys)

    sharded = jax.shard_map(
        local_cycle,
        mesh=mesh,
        in_specs=(P(), P(), P(CHAINS_AXIS), P(CHAINS_AXIS), P(), P()),
        out_specs=(P(CHAINS_AXIS), P(CHAINS_AXIS)),
    )
    jitted = jax.jit(sharded, donate_argnums=(2,))

    def call(states, keys, iter_start, saved_slots=None):
        if saved_slots is None:
            saved_slots = jnp.arange(cfg.n_iterations, dtype=jnp.int32)
        return jitted(graph, data, states, keys, iter_start,
                      jnp.asarray(saved_slots, dtype=jnp.int32))

    return call


def shard_states(states, mesh: Mesh):
    """Place a stacked chain-state pytree on the mesh's chains axis."""
    return jax.tree.map(
        lambda x: jax.device_put(
            x, NamedSharding(mesh, P(*([CHAINS_AXIS] + [None] * (x.ndim - 1))))
        ),
        states,
    )
