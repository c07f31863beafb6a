"""Gaussian-response Gibbs kernel — the heart of the sampler.

Pure-functional re-design of mcmc_nngp_update_Gaussian
(the reference's Scripts/mcmc_nngp_update_Gaussian.R).  One iteration
composes, in the reference's order:

  1. ancillary MH on (log_scale, shape) with the whitened field held fixed
     (field co-transformed through L_new^-1 L_old)            (ref :108-157)
  2. sufficient MH on (log_scale, shape) with the field fixed (ref :160-213)
  3. conjugate Gibbs for (beta_0, beta) + centered interweaving redraw of
     the location-indexed coefficients                        (ref :214-250)
  4. n_chromatic chromatic sweeps over the latent field       (ref :254-275)
  5. ten small MH steps on log_noise_variance                 (ref :277-293)
  6. record                                                    (ref :301-312)

plus the adaptive step-size rule (every 25 iterations while the cycle
starts at global iteration <= 2000, acceptance window [.05, .15],
+-N(.4,.05)/N(.2,.05) log-variance increments; ref :153-157, :209-213)
and the support constraints exp(log_scale) < var(y) (sufficient move only,
ref :167) and exp(log_noise_variance) < var(y) (ref :286).

Design notes:
- `lax.scan` over iterations; every block is fixed-shape.
- The chromatic field update walks colors with `lax.fori_loop`; each color
  step gathers per-site moralized-neighbor Q values (assembled once per
  iteration by one scatter-add) instead of the reference's per-color sparse
  crossprod — O(n * max_degree) per sweep instead of O(n_colors * nnz).
- The ancillary co-transform uses the level-scheduled triangular solve.
- Chains are vmapped outside this module (parallel/chains.py).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp
from jax import lax

from nngp_tpu.ops.covariance import exp_acc, shape_transform
from nngp_tpu.ops.reductions import df_sum
from nngp_tpu.ops.trisolve import level_solve
from nngp_tpu.ops.vecchia import (
    linv_mult,
    nngp_loglik_diff,
    precision_diag_and_q_edges,
    vecchia_linv,
)

_HIGHEST = jax.lax.Precision.HIGHEST


@dataclass(frozen=True)
class ChainState:
    """Mutable per-chain state (reference: states[[i]]$params +
    $transition_kernels, mcmc_nngp_initialize.R:143-209)."""

    beta_0: jax.Array            # []
    beta: jax.Array              # [p] (p may be 0)
    log_scale: jax.Array         # []
    log_noise_variance: jax.Array  # []
    shape: jax.Array             # [n_shape], sampled (unconstrained) scale
    field: jax.Array             # [n], centered (includes beta_0)
    tk_ancillary: jax.Array      # [] log-variance of the ancillary proposal
    tk_sufficient: jax.Array     # [] log-variance of the sufficient proposal
    # Adaptive-covariance (Haario AM) proposal state for the two
    # (log_scale, shape) MH blocks — an extension of the
    # reference's scalar step-size adaptation (mcmc_nngp_update_Gaussian.R
    # :153-157): a Welford running mean/M2 of the post-iteration
    # (log_scale, shape) vector shapes the joint proposal along the
    # posterior's own covariance (on Heavy-metals corr(log_scale,
    # log_range) ~ 0.5 and the isotropic proposal left log_range with
    # IACT ~ 100, experiments/slow_direction_diag.json).  None => the
    # reference's isotropic proposal (old checkpoints load as None).
    prop_mean: jax.Array | None = None   # [1 + n_shape]
    prop_m2: jax.Array | None = None     # [1 + n_shape, 1 + n_shape]
    prop_count: jax.Array | None = None  # []


jax.tree_util.register_dataclass(
    ChainState,
    data_fields=[
        "beta_0", "beta", "log_scale", "log_noise_variance", "shape",
        "field", "tk_ancillary", "tk_sufficient",
        "prop_mean", "prop_m2", "prop_count",
    ],
    meta_fields=[],
)


@dataclass(frozen=True)
class ModelData:
    """Immutable observation-side data (device arrays)."""

    y: jax.Array                 # [n_obs]
    X: jax.Array                 # [n_obs, p] centered design (p may be 0)
    X_locs_u: jax.Array          # [n, p_locs] location covariates at unique locs
    solve_1XT1X: jax.Array       # [p+1, p+1]
    chol_solve_1XT1X_lower: jax.Array  # [p+1, p+1] lower factor of solve_1XT1X
    var_y: jax.Array             # [] sample variance of y (support constraints)
    # support cap on every natural range parameter (4x the domain diameter
    # by default).  Ranges far beyond the domain are unidentifiable — the
    # reference's flat prior leaves an improper posterior tail there
    # (marginal likelihood flattens as corr -> 1), and the near-singular
    # f32 conditionals destabilize the sweep/beta cycle (a 96-chain run
    # had chains wander to range ~20x the sphere diameter and diverge to
    # NaN).  Truncating the support is a valid prior choice that makes the
    # posterior proper; it never binds at data-supported ranges.
    range_cap: jax.Array         # []
    # lower support on every natural range parameter — the mirror of
    # range_cap: at ranges far below the site spacing every correlation is
    # ~0, the likelihood goes flat in range, and with the reference's flat
    # prior a chain random-walks to log_range ~ -40 (observed on a
    # zero-signal toy: free accepts in the flat zone + growing step
    # sizes).  Default (None) = no floor; api.initialize sets median
    # nn-distance / 100, ~250x below any data-supported posterior.
    range_floor: jax.Array | None = None


jax.tree_util.register_dataclass(
    ModelData,
    data_fields=[
        "y", "X", "X_locs_u", "solve_1XT1X", "chol_solve_1XT1X_lower", "var_y",
        "range_cap", "range_floor",
    ],
    meta_fields=[],
)


@dataclass(frozen=True)
class UpdateConfig:
    """Static sampler knobs (reference run() signature, mcmc_nngp_run.R:1-5)."""

    n_iterations: int
    shape_names: tuple           # e.g. ("log_range",) — static transform spec
    locs_cols: tuple             # indices of location-indexed beta columns
    n_chromatic: int = 10
    ancillary: bool = True
    noise_steps: int = 10
    # number of (ancillary, sufficient) ASIS pairs per iteration on
    # (log_scale, shape).  The reference runs one pair (mcmc_nngp_update_
    # Gaussian.R:108-213); at n=58k each pair's conditional steps are tiny
    # relative to the marginal posterior, leaving log_range with IACT
    # ~100+ iterations — the Heavy-metals MPSRF bottleneck.  K pairs cut
    # that IACT ~K-fold for ~2(K-1) extra factor builds per iteration
    # (each pair is a valid posterior-preserving kernel, so any K targets
    # the same posterior).
    covparams_steps: int = 1
    adapt_until: int = 2000      # adapt while iter_start <= this (ref :153)
    adapt_window: int = 25
    # chromatic gather schedule: "classed" (degree-bucketed gathers) or
    # "flat" (single-width gathers, fewest steps)
    chromatic_schedule: str = "classed"
    # number of field snapshots recorded by one cycle call (field thinning
    # happens *inside* the scan so device memory never scales with the
    # un-thinned record length; ref field_thinning semantics
    # mcmc_nngp_update_Gaussian.R:56,311).  -1 = record every iteration.
    n_saved: int = -1
    # zero the chromatic innovation noise so the sweep is the deterministic
    # mean-field map — lets a sweep be checked against a float64 reference
    # walking the same block order (chip_smoke.py, tests/test_gibbs.py)
    zero_sweep_noise: bool = False
    # record only these field columns (static site indices) instead of the
    # full [n] field per kept snapshot.  At many chains the full-field
    # record is large (96 chains x 5 snapshots x 58k sites = 111 MB per
    # 100-iteration cycle); monitoring/ESS workflows that only track a
    # column subsample can cut that to ~nothing.  None = full field
    # (required for field estimation/prediction from the records).
    field_cols: tuple | None = None


def _natural_shape(cfg: UpdateConfig, sampled: jax.Array) -> jax.Array:
    return shape_transform(list(cfg.shape_names), sampled)


def _obs_sse(data: ModelData, field: jax.Array, mu: jax.Array, beta_0, graph):
    """sum (y - field[locs_match] - mu + beta_0)^2  (ref :281).

    Compensated reduction: the total is O(n_obs * noise_var) ~ 1e4-1e5 and
    later multiplies O(1) precision differences in the noise MH ratio, so
    plain f32 accumulation noise (~5e-4 relative) would leak O(0.1) into
    the log-ratio at Heavy-metals scale."""
    r = data.y - field[graph.locs_match] - mu + beta_0
    return df_sum(r * r)


def _obs_sse_diff(data: ModelData, field_new, field_old, mu, beta_0, graph):
    """sse(field_new) - sse(field_old) as ONE compensated reduction of
    per-observation differences: with r_new = r_old - delta,
    r_new^2 - r_old^2 = delta * (delta - 2 r_old).  Keeps the ancillary MH
    log-ratio (mcmc_nngp_update_Gaussian.R:129-133) free of the
    catastrophic big-total cancellation measured in
    experiments/ratio_audit_*.json."""
    delta = (field_new - field_old)[graph.locs_match]
    r_old = data.y - field_old[graph.locs_match] - mu + beta_0
    return df_sum(delta * (delta - 2.0 * r_old))


def _scale_support(data: ModelData, new_ls) -> jax.Array:
    """exp(log_scale) > var(y) * 1e-8: the lower-support mirror of the
    reference's exp(log_scale) < var(y) cap (ref :167).  With a flat prior
    and data carrying no (or weak) GP signal, log_scale otherwise drifts
    improperly to -inf until exp_acc(-log_scale) overflows f32 and the
    chromatic precision turns inf/NaN (observed at log_scale ~ -90 on a
    zero-signal toy).  1e-8 var(y) is ~5 orders below any resolvable GP
    variance share, so the floor never binds on data-supported scales."""
    return new_ls > jnp.log(data.var_y) - 18.42  # log(1e-8)


def _range_support(cfg: UpdateConfig, data: ModelData, natural,
                   sampled=None) -> jax.Array:
    """All natural range parameters within [data.range_floor,
    data.range_cap]; qlogis_* (Matern smoothness) bounded to |s| <= 6 on
    the sampled scale.  The smoothness transform nu = .5 + .5 sigmoid(s)
    saturates: beyond |s| ~ 6 the likelihood is flat in s (nu changes by
    < 2e-3) and with the reference's flat prior the chains drift
    improperly along the saturated tail (observed: a sharp-toy Matern fit
    with every chain's reported smoothness pinned at the 1.5-sigmoid
    ceiling and R-hat stuck ~1.5, experiments/matern_fit_sharp.jsonl).
    |s| <= 6 spans nu in [0.5012, 0.9988] — the transform's full usable
    resolution."""
    ok = jnp.asarray(True)
    floor = getattr(data, "range_floor", None)
    jr = 0
    for j, nm in enumerate(cfg.shape_names):
        if nm.startswith("log"):
            ok = ok & (natural[j] <= data.range_cap)
            if floor is not None:
                ok = ok & (natural[j] >= floor[jr])
            jr += 1
        elif nm.startswith("qlogis") and sampled is not None:
            ok = ok & (jnp.abs(sampled[j]) <= 6.0)
    return ok


# AM proposal activates once this many adaptation samples have been seen
# (before that the empirical covariance is too noisy to shape proposals)
_AM_MIN_COUNT = 100.0


def _proposal_chol(state: "ChainState"):
    """Lower Cholesky factor of the AM proposal shape, or None (isotropic).

    The proposal shape is the *correlation* matrix of the running
    (log_scale, shape) moments, shrunk 15% toward identity.  Correlation —
    not trace-normalized covariance — because each coordinate must keep
    its full exp(tk/2) marginal step: log_scale is moved ONLY by the two
    MH blocks, and a covariance-shaped proposal lets the burn-in range
    drift (variance spanning e^10 from the overdispersed inits) crowd the
    scale coordinate to a near-zero share, stalling its mixing (observed:
    HM log_scale R-hat stuck at ~1.12 with trace normalization).  The
    shrinkage caps any cross-correlation at 0.85 so no direction is ever
    starved below ~half its isotropic step.  Until _AM_MIN_COUNT samples
    the factor is the identity (exactly the reference's isotropic
    proposal).
    """
    if state.prop_mean is None:
        return None
    d = state.prop_mean.shape[0]
    dtype = state.prop_mean.dtype
    eye = jnp.eye(d, dtype=dtype)
    cov = state.prop_m2 / jnp.maximum(state.prop_count - 1.0, 1.0)
    tr = jnp.trace(cov) / d
    covn = cov / jnp.maximum(tr, 1e-30)
    # 15% identity blend: bounds how far any coordinate's share can fall
    # below isotropic while the accumulators are still drift-contaminated
    covn = 0.85 * covn + 0.15 * eye
    C = jnp.linalg.cholesky(covn)
    use = (state.prop_count >= _AM_MIN_COUNT) & jnp.isfinite(C).all()
    return jnp.where(use, C, eye)


def _mh_innovation(state, tk, C, key, dtype):
    """Joint (log_scale, shape) proposal innovation: exp(tk/2) * C z."""
    n_par = 1 + state.shape.shape[0]
    z = jax.random.normal(key, (n_par,), dtype=dtype)
    if C is not None:
        z = jnp.matmul(C, z, precision=_HIGHEST)
    return z * jnp.exp(0.5 * tk)


def _am_update(state: "ChainState", enabled, reset=False) -> "ChainState":
    """Welford update of the AM running moments with the current
    (log_scale, shape) value; no-op when disabled or when the state carries
    no AM fields (legacy checkpoints).

    ``reset`` restarts the accumulators at the current value — done once,
    halfway through the adaptation window, so the covariance frozen at
    adapt_until reflects the (near-)converged posterior rather than the
    overdispersed-init drift, which otherwise inflates the range direction
    by orders of magnitude (classic AM burn-in contamination)."""
    if state.prop_mean is None:
        return state
    x = jnp.concatenate([state.log_scale[None], state.shape])
    cnt = state.prop_count + 1.0
    delta = x - state.prop_mean
    mean = state.prop_mean + delta / cnt
    m2 = state.prop_m2 + jnp.outer(delta, x - mean)
    rs = jnp.asarray(reset)
    mean = jnp.where(rs, x, mean)
    m2 = jnp.where(rs, jnp.zeros_like(m2), m2)
    cnt = jnp.where(rs, 1.0, cnt)
    en = jnp.asarray(enabled)
    return replace(
        state,
        prop_mean=jnp.where(en, mean, state.prop_mean),
        prop_m2=jnp.where(en, m2, state.prop_m2),
        prop_count=jnp.where(en, cnt, state.prop_count),
    )


def _ancillary_step(graph, data, cfg, state, linv, mu, key, C=None):
    """Block 1: joint MH on (log_scale, shape), field co-transformed.

    w_new = beta_0 + e^{(ls'-ls)/2} L_new^-1 L_old (w - beta_0)  (ref :127);
    the whitened field is ancillary so the ratio is the observation
    log-likelihood difference only (ref :129-133).
    """
    k1, k2 = jax.random.split(key)
    innov = _mh_innovation(state, state.tk_ancillary, C, k1,
                           state.field.dtype)
    new_ls = state.log_scale + innov[0]
    new_shape = state.shape + innov[1:]
    natural_new = _natural_shape(cfg, new_shape)
    new_linv = vecchia_linv(graph, natural_new)
    v = linv_mult(linv, state.field - state.beta_0, graph)
    new_field = state.beta_0 + exp_acc(0.5 * (new_ls - state.log_scale)) * level_solve(
        new_linv, v, graph
    )
    prec = exp_acc(-state.log_noise_variance)
    llr = -0.5 * prec * _obs_sse_diff(
        data, new_field, state.field, mu, state.beta_0, graph
    )
    # the var(y) cap applies to BOTH MH moves (the reference caps only the
    # sufficient one, ref :167): with an uncapped ancillary move a chain
    # can be carried to log_scale > log var(y), where every sufficient
    # proposal is support-rejected, the step-size adaptation death-spirals
    # (tk -> -11) and the chain freezes out-of-support forever — observed
    # as exactly one of 96 HM chains stuck in a high-scale basin
    # (experiments/stuck96_diag.json), the stream-dependent R-hat ~30
    # plateaus of hm_96_*_run.log.  A support constraint is a property of
    # the (truncated) posterior, not of one move.
    accept = (_range_support(cfg, data, natural_new, new_shape)
              & _scale_support(data, new_ls)
              & (jnp.exp(new_ls) < data.var_y)
              & (llr > jnp.log(jax.random.uniform(k2, dtype=llr.dtype))))
    state = replace(
        state,
        log_scale=jnp.where(accept, new_ls, state.log_scale),
        shape=jnp.where(accept, new_shape, state.shape),
        field=jnp.where(accept, new_field, state.field),
    )
    linv = jnp.where(accept, new_linv, linv)
    return state, linv, accept.astype(linv.dtype)


def _sufficient_step(graph, data, cfg, state, linv, key, C=None):
    """Block 2: joint MH on (log_scale, shape), field fixed; ratio is the
    Vecchia GP prior log-density difference (ref :160-213), subject to
    exp(log_scale') < var(y) (ref :167)."""
    k1, k2 = jax.random.split(key)
    innov = _mh_innovation(state, state.tk_sufficient, C, k1,
                           state.field.dtype)
    new_ls = state.log_scale + innov[0]
    new_shape = state.shape + innov[1:]
    natural_new = _natural_shape(cfg, new_shape)
    new_linv = vecchia_linv(graph, natural_new)
    w0 = state.field - state.beta_0
    gp_ratio = nngp_loglik_diff(
        new_linv, new_ls, linv, state.log_scale, w0, graph
    )
    support = ((jnp.exp(new_ls) < data.var_y)
               & _scale_support(data, new_ls)
               & _range_support(cfg, data, natural_new, new_shape))
    accept = support & (gp_ratio > jnp.log(jax.random.uniform(k2, dtype=gp_ratio.dtype)))
    state = replace(
        state,
        log_scale=jnp.where(accept, new_ls, state.log_scale),
        shape=jnp.where(accept, new_shape, state.shape),
    )
    linv = jnp.where(accept, new_linv, linv)
    return state, linv, accept.astype(linv.dtype)


def _beta_step(graph, data, cfg, state, linv, key):
    """Block 3: regression coefficients (ref :214-250).

    - no location covariates: conjugate beta_0 draw from the GP prior of the
      centered field (ref :219-224); no field shift.
    - any covariates: non-centered conjugate draw of (beta_0, beta) from the
      observation residuals, field shifted by the beta_0 innovation
      (ref :226-235).
    - location covariates: interweaved centered redraw of
      (beta_0, beta[locs]) from the GP prior of field + X_locs beta_locs
      (ref :237-246).
    """
    p = state.beta.shape[0]
    p_locs = len(cfg.locs_cols)
    k1, k2, k3 = jax.random.split(key, 3)
    beta_0, beta, field = state.beta_0, state.beta, state.field
    dtype = field.dtype

    if p_locs == 0 or p == 0:
        ones = jnp.ones(graph.n, dtype=dtype)
        L1 = linv_mult(linv, ones, graph)
        s11 = df_sum(L1 * L1)
        cov = jnp.exp(state.log_scale) / s11
        Lw = linv_mult(linv, field, graph)
        # (1'Q w)/(1'Q 1): the exp(+-log_scale) factors cancel exactly —
        # forming them separately overflows to inf*0=NaN at extreme
        # log_scale (ref :219-224)
        mean = df_sum(Lw * L1) / s11
        beta_0 = mean + jnp.sqrt(cov) * jax.random.normal(k1, dtype=dtype)

    if p > 0:
        r = data.y - field[graph.locs_match] + beta_0
        rX1 = jnp.concatenate(
            [jnp.sum(r)[None], jnp.matmul(r, data.X, precision=_HIGHEST)]
        )
        bmean = jnp.matmul(rX1, data.solve_1XT1X, precision=_HIGHEST)
        z = jax.random.normal(k2, (p + 1,), dtype=dtype)
        innov = bmean + jnp.exp(0.5 * state.log_noise_variance) * jnp.matmul(
            data.chol_solve_1XT1X_lower, z, precision=_HIGHEST
        )
        field = field - beta_0 + innov[0]
        beta_0 = innov[0]
        beta = innov[1:]

        if p_locs > 0:
            lc = jnp.asarray(cfg.locs_cols, dtype=jnp.int32)
            ones = jnp.ones((graph.n, 1), dtype=dtype)
            X1l = jnp.concatenate([ones, data.X_locs_u], axis=1)   # [n, pl+1]
            LX = linv_mult(linv, X1l, graph)                        # [n, pl+1]
            # HIGHEST: these n-length contractions build the interweaved
            # beta precision (ref LAPACK doubles, :79-82); at the default
            # precision a float32 contraction may run with reduced-precision
            # operands (TF32 on tensor cores)
            P_iw = jnp.matmul(LX.T, LX, precision=_HIGHEST)
            # solve-based draw from N(P^-1 t, scale * P^-1): cholesky the
            # PRECISION and solve — inverting P_iw and then factoring the
            # inverse (the reference's covmat path, :80-81) loses symmetry
            # /definiteness in f32 when P_iw is ill-conditioned
            cL = jnp.linalg.cholesky(P_iw)
            other = field + jnp.matmul(data.X_locs_u, beta[lc],
                                       precision=_HIGHEST)
            t = jnp.matmul(LX.T, linv_mult(linv, other, graph),
                           precision=_HIGHEST)
            mean = jax.scipy.linalg.cho_solve((cL, True), t)
            z = jax.random.normal(k3, (p_locs + 1,), dtype=dtype)
            innov = mean + jnp.exp(0.5 * state.log_scale) * (
                jax.scipy.linalg.solve_triangular(cL, z, trans=1, lower=True)
            )
            beta_0 = innov[0]
            beta = beta.at[lc].set(innov[1:])
            field = other - jnp.matmul(data.X_locs_u, innov[1:],
                                       precision=_HIGHEST)

    return replace(state, beta_0=beta_0, beta=beta, field=field)


def sweep_inputs(graph, data, cfg, state, linv, mu):
    """Iteration-constant inputs of the chromatic sweeps: the per-class
    pregathered (c_sites, c_nbrs, q_blk, P_blk, rs_blk) tuples plus the
    scalar coefficients.  Shared by the XLA sweep path below and the
    halo-sharded path (parallel/halo.py), so both consume bit-identical
    inputs."""
    n = graph.n
    dtype = state.field.dtype
    pdiag, q_edges = precision_diag_and_q_edges(linv, graph)
    # residual scatter-sum (ref :260); independent of the field, so hoisted
    # out of the sweeps
    r_obs = data.y - mu
    rsum = jnp.zeros(n, dtype=dtype).at[graph.locs_match].add(r_obs)
    inv_scale = exp_acc(-state.log_scale)
    inv_noise = exp_acc(-state.log_noise_variance)
    obs_per_loc = jnp.asarray(graph.obs_per_loc)

    # degree-classed block schedule: per class the neighbor structure is
    # pre-gathered and truncated to the class width, so each block step
    # reads ~average-degree columns instead of the global max degree.
    if cfg.chromatic_schedule == "flat":
        # one class at the global max degree, fewest steps
        blocks = jnp.asarray(graph.chrom_blocks)
        safe_rows = jnp.minimum(blocks, n - 1)
        padded = (blocks >= n)[..., None]
        nbr_sites = jnp.asarray(graph.nbr_sites)
        nbr_edge = jnp.asarray(graph.nbr_edge)
        nbr_mask = jnp.asarray(graph.nbr_mask)
        classes = [(
            blocks,
            jnp.where(padded, n, nbr_sites[safe_rows]),
            jnp.where(padded, graph.n_edges, nbr_edge[safe_rows]),
            jnp.where(padded, 0.0, nbr_mask[safe_rows]),
        )]
    else:  # "classed"
        classes = list(
            zip(graph.chrom_sites, graph.chrom_nbrs, graph.chrom_edges,
                graph.chrom_nmask)
        )

    # hoist all iteration-constant gathers out of the sweeps: the Q values,
    # posterior precisions and residual sums per block depend on (linv, mu)
    # but not on the field, so they are gathered once per iteration instead
    # of once per sweep — only the field values move inside the loop
    pregathered = []
    for (c_sites, c_nbrs, c_edges, c_mask) in classes:
        c_sites = jnp.asarray(c_sites)
        c_nbrs = jnp.asarray(c_nbrs)
        sites_safe = jnp.minimum(c_sites, n - 1)
        q_blk = q_edges[jnp.asarray(c_edges)] * jnp.asarray(c_mask)
        P_blk = (inv_scale * pdiag[sites_safe]
                 + inv_noise * obs_per_loc[sites_safe])
        rs_blk = rsum[sites_safe]
        pregathered.append((c_sites, c_nbrs, q_blk, P_blk, rs_blk))
    return pregathered, inv_scale, inv_noise


def _chromatic_sweeps(graph, data, cfg, state, linv, mu, key):
    """Block 4: n_chromatic chromatic Gibbs sweeps of the field (ref :254-275).

    Per color c, for its sites s (all pairwise non-adjacent in the moralized
    graph): posterior precision P_s = e^{-ls} Q_ss + e^{-lnv} #obs(s), and
    conditional mean beta_0 - P_s^-1 (e^{-ls} sum_{j~s} Q_sj (w_j - beta_0)
    - e^{-lnv} residual_sum_s).  The neighbor sum replaces the reference's
    masked sparse crossprod (ref :269) — by properness of the coloring no
    moralized neighbor of s shares its color, so no masking is needed.
    """
    n = graph.n
    dtype = state.field.dtype
    beta_0 = state.beta_0
    w0 = jnp.concatenate([state.field, jnp.zeros(1, dtype=dtype)])
    pregathered, inv_scale, inv_noise = sweep_inputs(
        graph, data, cfg, state, linv, mu
    )

    def one_sweep(sweep, w):
        salt = sweep * 1_000_003
        for ci, (c_sites, c_nbrs, q_blk, P_blk, rs_blk) in enumerate(pregathered):
            nb_blocks = c_sites.shape[0]

            def block_step(b, w, c_sites=c_sites, c_nbrs=c_nbrs, q_blk=q_blk,
                           P_blk=P_blk, rs_blk=rs_blk, ci=ci):
                kc = jax.random.fold_in(key, salt + ci * 10_007 + b)
                sites = c_sites[b]                       # [B], pad = n
                prior = jnp.sum(q_blk[b] * (w[c_nbrs[b]] - beta_0), axis=1)
                P = P_blk[b]
                mean = beta_0 - (inv_scale * prior - inv_noise * rs_blk[b]) / P
                noise = jax.random.normal(kc, sites.shape, dtype=dtype) * lax.rsqrt(P)
                if cfg.zero_sweep_noise:
                    noise = noise * 0
                return w.at[sites].set(mean + noise)

            w = lax.fori_loop(0, nb_blocks, block_step, w)
        return w

    w = lax.fori_loop(0, cfg.n_chromatic, one_sweep, w0)
    return replace(state, field=w[:n])


def _noise_steps(graph, data, cfg, state, mu, key):
    """Block 5: `noise_steps` small MH moves on log_noise_variance
    (ref :277-293; fixed proposal sd 0.01, support exp(.) < var(y))."""
    sse = _obs_sse(data, state.field, mu, state.beta_0, graph)
    n_obs = graph.n_obs
    dtype = state.field.dtype

    def body(i, lnv):
        k = jax.random.fold_in(key, i)
        k1, k2 = jax.random.split(k)
        innov = jax.random.normal(k1, dtype=dtype) * 0.01
        # expm1 form of exp(-lnv-innov) - exp(-lnv): the two exps are equal
        # to ~1e-7 relative, so differencing them directly would leave
        # O(eps * sse * prec) ~ 0.01 noise in the ratio at n=64k
        ratio = -0.5 * n_obs * innov - 0.5 * sse * exp_acc(-lnv) * jnp.expm1(
            -innov
        )
        ok = (jnp.exp(lnv + innov) < data.var_y) & (
            ratio > jnp.log(jax.random.uniform(k2, dtype=dtype))
        )
        return jnp.where(ok, lnv + innov, lnv)

    lnv = lax.fori_loop(0, cfg.noise_steps, body, state.log_noise_variance)
    return replace(state, log_noise_variance=lnv)


def _adapt(tk, acc_count, key, enabled, mean_step, window, am_active=False):
    """Adaptive step-size rule (ref :153-157, :209-213): acceptance below
    .05 shrinks the proposal log-variance by N(mean_step, .05); above .15
    grows it.

    When the AM covariance proposal is active the acceptance band rises to
    [.15, .35]: the reference's low band compensates an isotropic proposal
    in a correlated target by forcing huge steps; with a posterior-shaped
    proposal the random-walk optimum for d=2-4 is ~0.25-0.35 acceptance."""
    rate = acc_count / window
    am = jnp.asarray(am_active)
    lo = jnp.where(am, 0.15, 0.05)
    hi = jnp.where(am, 0.35, 0.15)
    step = mean_step + 0.05 * jax.random.normal(key, dtype=tk.dtype)
    new_tk = jnp.where(rate < lo, tk - step, jnp.where(rate > hi, tk + step, tk))
    # clamp: in the weakly-identified support-box corners acceptance stays
    # high regardless of step size, so unclamped tk grows ~0.4/window until
    # proposals teleport chains across the whole box (a 96-chain HM run had
    # tk reach ~+8 => proposal sd e^4 ~ 55 in log_scale, the chains hit the
    # pre-floor -90 region and overflowed).  sd e^3 ~ 20 spans any box.
    new_tk = jnp.clip(new_tk, -30.0, 6.0)
    return jnp.where(enabled, new_tk, tk)


def _mu_obs(data, state, graph):
    """Per-observation fixed-effect mean mu = beta_0 + X beta (ref :85,249)."""
    if data.X.shape[1] > 0:
        return state.beta_0 + jnp.matmul(data.X, state.beta,
                                         precision=_HIGHEST)
    return jnp.full(graph.n_obs, state.beta_0, dtype=state.field.dtype)


def _pre_chromatic(graph, data, cfg: UpdateConfig, carry, xs):
    """Blocks 1-3 of one Gibbs iteration (interweaved MH + adaptation +
    beta), shared between the per-chain and chains-batched iteration
    bodies.  Returns the updated carry plus the refreshed mu and the two
    remaining block keys."""
    state, linv, acc_anc, acc_suf = carry
    key, it, iter_start = xs
    keys = jax.random.split(key, 6)

    mu = _mu_obs(data, state, graph)
    C = _proposal_chol(state)
    am_active = (False if state.prop_mean is None
                 else state.prop_count >= _AM_MIN_COUNT)
    for rep in range(max(1, cfg.covparams_steps)):
        k_anc = jax.random.fold_in(keys[0], rep)
        k_suf = jax.random.fold_in(keys[1], rep)
        if cfg.ancillary:
            state, linv, a = _ancillary_step(graph, data, cfg, state, linv,
                                             mu, k_anc, C=C)
            acc_anc = acc_anc + a
        state, linv, a = _sufficient_step(graph, data, cfg, state, linv,
                                          k_suf, C=C)
        acc_suf = acc_suf + a

    # adaptation every `window` iterations while the cycle starts early
    # enough (ref checks iter_start in 0..2000); acceptance rates count
    # covparams_steps sub-steps per iteration
    window = cfg.adapt_window * max(1, cfg.covparams_steps)
    do_adapt = (it + 1) % cfg.adapt_window == 0
    enabled = iter_start <= cfg.adapt_until
    ka1, ka2 = jax.random.split(keys[2])
    tk_anc = jnp.where(
        do_adapt,
        _adapt(state.tk_ancillary, acc_anc, ka1, enabled, 0.4, window,
               am_active),
        state.tk_ancillary,
    )
    tk_suf = jnp.where(
        do_adapt,
        _adapt(state.tk_sufficient, acc_suf, ka2, enabled, 0.2, window,
               am_active),
        state.tk_sufficient,
    )
    acc_anc = jnp.where(do_adapt, 0.0, acc_anc)
    acc_suf = jnp.where(do_adapt, 0.0, acc_suf)
    state = replace(state, tk_ancillary=tk_anc, tk_sufficient=tk_suf)
    gi = iter_start + it
    # moments accumulate from the start (the drift-shaped early proposal
    # helps extreme-init chains traverse the scale~range ridge during
    # burn-in: the one 96-chain run with delayed activation left tail
    # chains crawling isotropically and R-hat stuck ~29, while the
    # accumulate-from-start run converged — experiments/
    # hm_96_2phase_prefloor_run.log vs hm_96_K1_run.log), reset twice
    # (at adapt_until/2 and at the tk freeze) so the post-freeze shape
    # reflects the stationary posterior, and never freeze (diminishing
    # adaptation, Welford updates shrink as 1/count).
    state = _am_update(state, True,
                       reset=(gi == cfg.adapt_until // 2)
                       | (gi == cfg.adapt_until))

    state = _beta_step(graph, data, cfg, state, linv, keys[3])
    mu = _mu_obs(data, state, graph)
    return (state, linv, acc_anc, acc_suf), mu, keys[4], keys[5]


def gibbs_iteration(graph, data, cfg: UpdateConfig, carry, xs):
    """One full Gibbs iteration (scan body)."""
    (state, linv, acc_anc, acc_suf), mu, k_sweep, k_noise = _pre_chromatic(
        graph, data, cfg, carry, xs
    )
    state = _chromatic_sweeps(graph, data, cfg, state, linv, mu, k_sweep)
    state = _noise_steps(graph, data, cfg, state, mu, k_noise)

    record = {
        "beta_0": state.beta_0,
        "beta": state.beta,
        "log_scale": state.log_scale,
        "log_noise_variance": state.log_noise_variance,
        "shape": state.shape,
    }
    return (state, linv, acc_anc, acc_suf), record


def run_cycle(graph, data, cfg: UpdateConfig, state: ChainState, key,
              iter_start, saved_slots=None):
    """One chain x n_iterations cycle: returns (new_state, stacked records).

    Equivalent of one mclapply worker body (ref :27-315); the Vecchia factor
    is rebuilt from the current state at cycle start (ref :67-74).

    ``saved_slots`` (i32 [n_iterations], values in [0, cfg.n_saved]) routes
    each iteration's field snapshot into a preallocated record buffer inside
    the scan — slot ``cfg.n_saved`` is a discard row, so thinned-out
    iterations cost no HBM.  None records every iteration.
    """
    linv0 = vecchia_linv(graph, _natural_shape(cfg, state.shape))
    keys = jax.random.split(key, cfg.n_iterations)
    its = jnp.arange(cfg.n_iterations)
    starts = jnp.full((cfg.n_iterations,), iter_start)
    # derived from state so the carry is device-varying under shard_map
    zero = state.log_scale * 0
    n_saved = cfg.n_iterations if cfg.n_saved < 0 else cfg.n_saved
    if saved_slots is None:
        saved_slots = jnp.arange(cfg.n_iterations, dtype=jnp.int32)
    else:
        saved_slots = jnp.asarray(saved_slots, dtype=jnp.int32)
    rec_cols = (None if cfg.field_cols is None
                else jnp.asarray(cfg.field_cols, dtype=jnp.int32))
    rec_width = graph.n if cfg.field_cols is None else len(cfg.field_cols)
    fbuf0 = jnp.zeros((n_saved + 1, rec_width), dtype=state.field.dtype) + zero

    def body(carry, xs):
        inner, fbuf = carry[:-1], carry[-1]
        (_, it, _) = xs
        inner, rec = gibbs_iteration(graph, data, cfg, inner, xs)
        snap = (inner[0].field if rec_cols is None
                else inner[0].field[rec_cols])
        fbuf = lax.dynamic_update_slice(
            fbuf, snap[None], (saved_slots[it], 0)
        )
        return inner + (fbuf,), rec

    (state, _, _, _, fbuf), records = lax.scan(
        body, (state, linv0, zero, zero, fbuf0), (keys, its, starts)
    )
    records = dict(records)
    records["field"] = fbuf[:n_saved]
    return state, records


from functools import partial


@partial(jax.jit, static_argnums=(0,), donate_argnums=(3,))
def _cycle_jit(cfg: UpdateConfig, graph, data, states, keys, iter_start,
               saved_slots=None):
    """Module-level jitted cycle so the compile cache is shared across
    problem instances (same shapes + same static cfg => cache hit)."""
    return jax.vmap(
        lambda s, k: run_cycle(graph, data, cfg, s, k, iter_start,
                               saved_slots=saved_slots)
    )(states, keys)


def make_cycle_fn(graph, data, cfg: UpdateConfig):
    """Chain-vmapped cycle update: (states, keys, iter_start) ->
    (states', records) with a leading chains axis on states/keys/records.

    graph/data are passed as traced jit arguments (not closure constants) so
    XLA does not constant-fold the large gather/scatter index maps into the
    executable."""

    def call(states, keys, iter_start, saved_slots=None):
        return _cycle_jit(cfg, graph, data, states, keys, iter_start,
                          saved_slots)

    return call
