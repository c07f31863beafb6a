"""Cross-device convergence diagnostics via XLA collectives.

The stopping decision needs cross-chain within/between covariances
(mcmc_nngp_diagnose.R:12-21).  When chains are sharded over devices/hosts,
the moments are reduced with `lax.pmean` over the chains mesh axis so that
records never leave their device — only the p x p moment matrices move
between devices (SURVEY.md §5 'Distributed communication backend').
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from nngp_tpu.parallel.chains import CHAINS_AXIS


def _grb_from_moments(W, B, n, m):
    """R-hat formulas with the reference's df constants
    (mcmc_nngp_diagnose.R:18-21)."""
    lam = jnp.linalg.svd(jnp.linalg.solve(W, B), compute_uv=False)[0]
    mpsrf = (n - 1) / n + (m + 1) / m * lam
    ind = ((m + 1) / m) * ((n - 1) / n) * (jnp.diag(B) / jnp.diag(W)) + (n + 1) / n
    return jnp.concatenate([mpsrf[None], ind])


def collective_grb(samples: jax.Array, n_chains_total: int, axis=CHAINS_AXIS):
    """R-hat from device-local chain samples, inside shard_map.

    samples: [local_chains, T, p] — the non-field parameter block of each
    local chain after burn-in.  Returns the [1+p] R-hat vector, replicated.
    """
    T = samples.shape[1]
    m = n_chains_total
    means = jnp.mean(samples, axis=1)                      # [lc, p]
    centered = samples - means[:, None, :]
    covs = jnp.einsum("ctp,ctq->cpq", centered, centered,
                      precision=lax.Precision.HIGHEST) / (T - 1)
    # within = average of per-chain covariances (diagnose.R:13-14)
    W = lax.pmean(jnp.mean(covs, axis=0), axis)
    # between = covariance of the chain means (diagnose.R:15-16):
    # psum of deviation outer products over all chains / (m - 1)
    mean_of_means = lax.pmean(jnp.mean(means, axis=0), axis)
    dev = means - mean_of_means
    B = lax.psum(jnp.einsum("cp,cq->pq", dev, dev,
                            precision=lax.Precision.HIGHEST), axis) / (m - 1)
    return _grb_from_moments(W, B, T, m)


def make_collective_grb_fn(mesh, n_chains_total: int):
    """shard_map wrapper: [chains, T, p] sharded samples -> replicated R-hat."""

    def fn(samples):
        return collective_grb(samples, n_chains_total)

    return jax.jit(
        jax.shard_map(
            fn, mesh=mesh, in_specs=P(CHAINS_AXIS), out_specs=P()
        )
    )
