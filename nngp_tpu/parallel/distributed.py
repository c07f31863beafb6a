"""Multi-host execution: `jax.distributed` bring-up + the global chains mesh.

The reference's only parallelism is fork-per-chain on one node
(mcmc_nngp_update_Gaussian.R:25, joined per cycle at mcmc_nngp_run.R:22-33).
Here chains are sharded over every device of every process (SURVEY.md §2c):
each process runs its local chains inside one shard_map'd cycle program,
records stay host-local, and only the p x p Gelman-Rubin moment matrices
cross devices (parallel/collectives.py).

Bring-up is explicit, so the same script works under any launcher:

    NNGP_COORDINATOR=host0:port  NNGP_NUM_PROCESSES=k  NNGP_PROCESS_ID=i

(``JAX_COORDINATOR_ADDRESS`` is accepted in place of NNGP_COORDINATOR).
On CPU the cross-process collectives use the gloo backend — the same code
path exercised by tests/test_distributed.py with 2 local processes.
"""

from __future__ import annotations

import os

import jax

from nngp_tpu.parallel.chains import chains_mesh


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join (or start) the distributed runtime.  Returns True if the runtime
    is live after the call, False when running single-process (no coordinator
    configured).  Safe to call more than once."""
    from jax._src import distributed as _dist

    if _dist.global_state.client is not None:  # already initialized
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "NNGP_COORDINATOR"
    ) or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("NNGP_NUM_PROCESSES"):
        num_processes = int(os.environ["NNGP_NUM_PROCESSES"])
    if process_id is None and os.environ.get("NNGP_PROCESS_ID"):
        process_id = int(os.environ["NNGP_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_chains_mesh():
    """1-D 'chains' mesh over every device of every process."""
    return chains_mesh(jax.devices())


def local_chain_slice(n_chains_total: int, mesh=None):
    """The [lo, hi) chain-index range owned by this process when
    ``n_chains_total`` chains are sharded over ``mesh`` (device-major,
    contiguous per process — the layout shard_states produces)."""
    if mesh is None:
        mesh = global_chains_mesh()
    n_dev = mesh.size
    per_dev = n_chains_total // n_dev
    # positions of this process' devices within the mesh order (device ids
    # are process-offset, e.g. 0,1,2048,2049 on multi-process CPU — only the
    # mesh position determines the chain shard)
    pos = {d: i for i, d in enumerate(mesh.devices.flat)}
    local = sorted(pos[d] for d in jax.local_devices() if d in pos)
    lo = local[0] * per_dev
    hi = (local[-1] + 1) * per_dev
    return lo, hi
