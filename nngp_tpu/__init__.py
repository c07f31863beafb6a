"""nngp_tpu — a JAX MCMC engine for Nearest-Neighbor Gaussian Process models
with full data augmentation.

A from-scratch JAX/XLA re-design of the algorithms in the reference R
implementation (Coube & Liquet, arXiv 2010.00896; supplementary repo
``Improving-performances-of-MCMC-for-Nearest-Neighbor-Gaussian-Process-models-
with-full-data-augmentat``):

- Vecchia (NNGP) approximation over a fixed-width ``[n, m+1]`` neighbor array,
  with the sparse inverse-Cholesky factor built as a batched, fully vectorized
  kernel (reference: GpGp::vecchia_Linv).
- Chromatic (graph-colored) blocked Gibbs updates of the latent field
  (reference: Scripts/Coloring.R, Scripts/mcmc_nngp_update_Gaussian.R:254-275).
- Ancillary/sufficient interweaving (ASIS) Metropolis updates of the
  covariance parameters (reference: mcmc_nngp_update_Gaussian.R:108-213).
- Interweaved centered/non-centered conjugate updates of regression
  coefficients (reference: mcmc_nngp_update_Gaussian.R:214-250).
- Chains vectorized with ``jax.vmap`` and sharded over a device mesh with
  ``jax.shard_map`` (reference: fork-based parallel::mclapply).

Public API mirrors the reference entry points:
``initialize``, ``run``, ``estimate``, ``predict_field``,
``predict_fixed_effects``, ``Gelman_Rubin_Brooks``, ``ESS``.
"""

from nngp_tpu.api import (
    initialize,
    run,
    estimate,
    predict_field,
    predict_fixed_effects,
    save,
    load,
)
from nngp_tpu.diagnostics.grb import Gelman_Rubin_Brooks
from nngp_tpu.diagnostics.ess import ESS

__version__ = "0.1.0"

__all__ = [
    "initialize",
    "run",
    "estimate",
    "predict_field",
    "predict_fixed_effects",
    "save",
    "load",
    "Gelman_Rubin_Brooks",
    "ESS",
]
