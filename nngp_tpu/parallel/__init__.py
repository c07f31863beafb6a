"""Chain parallelism over device meshes.

The reference's only parallelism is fork-per-chain mclapply
(mcmc_nngp_update_Gaussian.R:25, joined at mcmc_nngp_run.R:22-33).  Here
chains are a vmapped batch axis sharded over a ``jax.sharding.Mesh`` with
``jax.shard_map``; cross-chain reductions (Gelman-Rubin-Brooks moments,
pooled acceptance statistics) ride XLA collectives.
"""

from nngp_tpu.parallel.chains import chains_mesh, make_sharded_cycle_fn
from nngp_tpu.parallel.collectives import collective_grb
from nngp_tpu.parallel.distributed import (
    global_chains_mesh,
    initialize_distributed,
    local_chain_slice,
)

__all__ = [
    "chains_mesh", "make_sharded_cycle_fn", "collective_grb",
    "initialize_distributed", "global_chains_mesh", "local_chain_slice",
]
