"""Posterior predictive simulation at new locations.

Parity with mcmc_nngp_predict (Scripts/mcmc_nngp_predict.R):

- ``mcmc_nngp_predict_field``: joint ordered-NN array over
  [training locs; predicted locs] (ref :4-8), then per retained posterior
  sample a conditional simulation
      w_pred = sd * solve(L_joint, [L_obs (w - beta_0)/sd ; z])[n:]
  (ref :44-53).  Design: instead of the reference's
  recompute-only-when-shape-changed loop over samples (ref :23,32-41), the
  Vecchia factor build and the level-scheduled triangular solve are vmapped
  over chunks of posterior samples — recomputation is cheaper than
  deduplication on a batched device.
- ``mcmc_nngp_predict_fixed_effects``: beta samples x model matrix with
  name matching and optional intercept (ref :67-104).

Smoothness transform: uses the sampler's nu = .5 + .5*sigmoid transform for
internal consistency (the reference inconsistently uses 1.5*sigmoid here,
mcmc_nngp_predict.R:37 — see ops/covariance.py docstring).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from nngp_tpu.estimation import get_summary
from nngp_tpu.ops.covariance import shape_transform
from nngp_tpu.ops.trisolve import level_solve
from nngp_tpu.ops.vecchia import linv_mult, vecchia_linv
from nngp_tpu.preprocess.coloring import (
    blocked_groups,
    dag_levels,
    level_segments,
)
from nngp_tpu.preprocess.neighbors import find_ordered_nn
from nngp_tpu.preprocess.ordering import lonlat_to_xyz


@dataclass(frozen=True)
class _SolveGraph:
    """Minimal graph view consumed by vecchia_linv/linv_mult/level_solve."""

    kernel_coords: jax.Array
    nn_dist2: jax.Array
    NNarray: jax.Array
    nn_mask: jax.Array
    levels_idx: jax.Array
    level_segs: tuple
    covfun: str
    d_floor: float = 1e-12

    @property
    def n(self) -> int:
        return self.NNarray.shape[0]

    @property
    def m(self) -> int:
        return self.NNarray.shape[1] - 1


jax.tree_util.register_dataclass(
    _SolveGraph,
    data_fields=["kernel_coords", "nn_dist2", "NNarray", "nn_mask",
                 "levels_idx", "level_segs"],
    meta_fields=["covfun", "d_floor"],
)


def _joint_graph(mc, predicted_locs, m):
    covfun = mc.space_time_model["covfun"]["stationary_covfun"]
    lonlat = "sphere" in covfun
    joint = np.concatenate([mc.locs, np.asarray(predicted_locs, np.float64)], 0)
    NN = find_ordered_nn(joint, m, lonlat=lonlat)
    levels = dag_levels(NN)
    n_joint = NN.shape[0]
    levels_idx = blocked_groups(levels, int(min(2048, max(128, n_joint))), n_sentinel=n_joint)
    level_segs = level_segments(levels, n_sentinel=n_joint)
    coords = lonlat_to_xyz(joint) if lonlat else joint
    from nngp_tpu.preprocess.graph import nn_group_sqdist

    return _SolveGraph(
        kernel_coords=jnp.asarray(coords, jnp.float32),
        nn_dist2=jnp.asarray(nn_group_sqdist(coords, NN, covfun)),
        NNarray=jnp.asarray(NN),
        nn_mask=jnp.asarray((NN >= 0).astype(np.float32)),
        levels_idx=jnp.asarray(levels_idx),
        level_segs=tuple(jnp.asarray(t) for t in level_segs),
        covfun=covfun,
        d_floor=1e-5 if covfun.startswith("matern") else 1e-12,
    )


def _stored_idx(mc, burn_in):
    sf = mc.records[0]["saved_field"]
    return sf[sf > burn_in * sf.max()]


def mcmc_nngp_predict_field(
    mc, predicted_locs, burn_in: float = 0.5, m: int = 10, sample_chunk: int = 32
):
    """Latent-field prediction at ``predicted_locs`` (ref :1-60)."""
    if getattr(mc, "field_record_columns", None) is not None:
        raise ValueError(
            "predict_field needs full-field snapshots but the records are "
            "column-subsampled (the fit was run with field_record_columns). "
            "Re-run the sampling cycles without field_record_columns to "
            "collect full field records before predicting."
        )
    predicted_locs = np.asarray(predicted_locs, dtype=np.float64)
    g = _joint_graph(mc, predicted_locs, m)
    n = mc.graph.n
    n_pred = predicted_locs.shape[0]
    names = list(mc.space_time_model["covfun"]["shape_params"])
    stored = _stored_idx(mc, burn_in)
    n_samples = len(stored)

    def one_sample(shape, log_scale, beta_0, field, z):
        natural = shape_transform(names, shape)
        linv_j = vecchia_linv(g, natural)
        sd = jnp.exp(0.5 * log_scale)
        # L_obs (w - beta_0)/sd : the first n rows of the joint factor only
        # reference neighbors < n (ordered NN precede), so pad the field
        w_ext = jnp.concatenate(
            [(field - beta_0) / sd, jnp.zeros(n_pred, dtype=field.dtype)]
        )
        v = linv_mult(linv_j, w_ext, g)[:n]
        rhs = jnp.concatenate([v, z])
        w_joint = level_solve(linv_j, rhs, g)
        return sd * w_joint[n:]

    batched = jax.jit(jax.vmap(one_sample))
    key = jax.random.key(mc.seed + 777)

    per_chain = []
    for ci, rec in enumerate(mc.records):
        sf = rec["saved_field"]
        field_rows = np.searchsorted(sf, stored)
        shapes = jnp.asarray(rec["shape"][stored - 1], jnp.float32)
        lss = jnp.asarray(rec["log_scale"][stored - 1], jnp.float32)
        b0s = jnp.asarray(rec["beta_0"][stored - 1], jnp.float32)
        fields = jnp.asarray(rec["field"][field_rows], jnp.float32)
        out = np.zeros((n_samples, n_pred), dtype=np.float32)
        for lo in range(0, n_samples, sample_chunk):
            hi = min(lo + sample_chunk, n_samples)
            z = jax.random.normal(
                jax.random.fold_in(key, ci * 100003 + lo),
                (hi - lo, n_pred),
                dtype=jnp.float32,
            )
            out[lo:hi] = np.asarray(
                batched(shapes[lo:hi], lss[lo:hi], b0s[lo:hi], fields[lo:hi], z)
            )
        per_chain.append(out)

    allsamples = np.concatenate(per_chain, axis=0)
    return {
        "predicted_locs": predicted_locs,
        "predicted_field_samples": per_chain,
        "predicted_field_summary": get_summary(allsamples),
    }


def mcmc_nngp_predict_fixed_effects(
    mc,
    X_predicted,
    burn_in: float = 0.5,
    match_field_thinning: bool = True,
    add_intercept: bool = False,
):
    """Fixed-effect prediction = beta samples x model matrix (ref :67-104)."""
    from nngp_tpu.preprocess.design import _expand_columns

    cols, names = _expand_columns(X_predicted)
    MM = np.stack(cols, axis=1) if cols else np.zeros((0, 0))
    fixed_effects_names = list(names)
    if add_intercept:
        MM = np.concatenate([np.ones((MM.shape[0], 1)), MM], axis=1)
        fixed_effects_names = ["beta_0"] + fixed_effects_names

    if match_field_thinning:
        stored = mc.records[0]["saved_field"]
    else:
        stored = np.arange(1, mc.iterations + 1)
    stored = stored[stored > burn_in * stored.max()]

    all_names = ["beta_0"] + list(mc.design.names)
    subset = []
    for nm in fixed_effects_names:
        if nm not in all_names:
            raise ValueError(
                f"predicted covariate {nm!r} not among fitted effects {all_names}"
            )
        subset.append(all_names.index(nm))
    subset = np.asarray(subset, dtype=np.int64)

    per_chain = []
    for rec in mc.records:
        b0 = rec["beta_0"][stored - 1][:, None]
        if rec["beta"] is not None and rec["beta"].shape[1] > 0:
            b = rec["beta"][stored - 1]
            b0 = b0 - b @ mc.design.X_mean[:, None]  # de-center (ref :94)
            beta_matrix = np.concatenate([b0, b], axis=1)
        else:
            beta_matrix = b0
        per_chain.append(beta_matrix[:, subset] @ MM.T)

    allsamples = np.concatenate(per_chain, axis=0)
    return {
        "X_predicted": X_predicted,
        "predicted_fixed_effects_samples": per_chain,
        "predicted_fixed_effects_summary": get_summary(allsamples),
    }
