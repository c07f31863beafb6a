"""End-to-end halo-sharded Gibbs cycle: `run(mc, mesh=Mesh(..., ('chains',
'sites')))` (VERDICT r2 item 4).

Per chain, the full six-block iteration of models/gaussian.py runs inside a
`shard_map` over the 'sites' mesh axis with all gather/scatter-bound work
sharded by site ownership (parallel/halo.py HaloPlan) and every O(n)
reduction computed as an owned-rows partial + `psum`:

- factor build: each device builds only its need-set rows (owned + halo) —
  the only rows any of its consumers read (halo.py design notes).
- ancillary co-transform: rhs at owned rows, halo level solve (ppermute
  ring exchanges), compensated obs-SSE difference over owned observations.
- sufficient ratio: per-owned-row loglik difference terms + psum.
- beta blocks: owned-row partial crossproducts + psum; identical proposal
  keys on every device make the draws and MH decisions replicated.
- chromatic sweeps: per-device pregathered class tiles (only this device's
  block positions are gathered), eager halo exchange per block, one
  reconcile per iteration.
- noise MH: owned-observation SSE partial + psum.

Scalar blocks replicate bit-identically across the axis (same fold-in keys
=> same draws), so MH accepts never diverge between devices.  Work and
gather volume scale ~n/D + boundary; field/mirror memory is O(n) per device
(work sharding, not memory sharding — the reference workloads fit HBM
easily, SURVEY.md §5 long-context row).

Reference semantics: mcmc_nngp_update_Gaussian.R blocks 1-6 (same order,
same adaptation, same support constraints as models/gaussian.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from dataclasses import replace

from nngp_tpu.models.gaussian import (
    _AM_MIN_COUNT,
    ChainState,
    UpdateConfig,
    _adapt,
    _am_update,
    _mh_innovation,
    _mu_obs,
    _proposal_chol,
    _range_support,
    _scale_support,
)
from nngp_tpu.ops.covariance import (
    correlation_from_sqdist,
    exp_acc,
    log1p_acc,
    shape_transform,
)
from nngp_tpu.ops.reductions import pairwise_df_sum
from nngp_tpu.ops.vecchia import linv_rows_from_K
from nngp_tpu.parallel.halo import (
    SITES_AXIS,
    HaloPlan,
    _exchange,
    _varying,
    halo_level_solve,
    reconcile,
)

_HIGHEST = jax.lax.Precision.HIGHEST


def _natural(cfg: UpdateConfig, sampled):
    return shape_transform(list(cfg.shape_names), sampled)


def _psum_df(terms, axis):
    """Compensated local sum -> one scalar psum over the sites axis."""
    hi, lo = pairwise_df_sum(terms)
    return lax.psum(hi + lo, axis)


def halo_vecchia_linv(graph, plan: HaloPlan, natural, d):
    """Factor mirror [n, m+1], fresh at this device's need rows (zeros
    elsewhere).  Work: O(Nmax * m^3) per device."""
    n = plan.n
    rows = jnp.asarray(plan.need_rows)[d]           # [Nmax], pad = n
    safe = jnp.minimum(rows, n - 1)
    K = correlation_from_sqdist(
        graph.covfun, jnp.asarray(graph.nn_dist2)[safe], natural
    )
    mask = jnp.asarray(graph.nn_mask)[safe]
    vals = linv_rows_from_K(K, mask, getattr(graph, "d_floor", 1e-12))
    k = vals.shape[-1]
    out = jnp.zeros((n + 1, k), dtype=vals.dtype)
    out = out.at[jnp.where(rows < n, rows, n)].set(vals)
    return out[:n]


def rows_linv_mult(linv, x, graph, rows):
    """(L x) values at `rows` (pad = n -> 0).  x: full fresh mirror [n],
    or [n, c] for the 2-D variant."""
    n = graph.n
    safe = jnp.minimum(rows, n - 1)
    NN = jnp.asarray(graph.NNarray)[safe]
    msk = jnp.asarray(graph.nn_mask)[safe]
    lv = linv[safe]
    real = (rows < n)
    if x.ndim == 1:
        vals = x[jnp.maximum(NN, 0)] * msk
        return jnp.sum(lv * vals, axis=1) * real
    vals = x[jnp.maximum(NN, 0)] * msk[..., None]
    out = jnp.einsum("rk,rkc->rc", lv, vals, precision=_HIGHEST)
    return out * real[:, None]


def halo_q_assembly(linv, graph, plan: HaloPlan, d):
    """(pdiag [n], q_edges [E+1]) assembled from this device's need rows —
    fresh at owned sites and owned-incident moralized edges (every row
    contributing to those is moralized-adjacent to an owned site, hence in
    the need set)."""
    n = graph.n
    rows = jnp.asarray(plan.need_rows)[d]
    safe = jnp.minimum(rows, n - 1)
    real = (rows < n).astype(linv.dtype)
    NN = jnp.asarray(graph.NNarray)[safe]
    lv = linv[safe] * jnp.asarray(graph.nn_mask)[safe] * real[:, None]
    pdiag = jnp.zeros(n, dtype=linv.dtype).at[jnp.maximum(NN, 0)].add(lv * lv)
    pa = jnp.asarray(graph.pair_a, dtype=jnp.int32)
    pb = jnp.asarray(graph.pair_b, dtype=jnp.int32)
    prods = lv[:, pa] * lv[:, pb]
    q_edges = (
        jnp.zeros(graph.n_edges + 1, dtype=linv.dtype)
        .at[jnp.asarray(graph.pair_edge_id)[safe]]
        .add(prods)
    )
    return pdiag, q_edges


def halo_sweep_inputs(graph, plan: HaloPlan, d, pdiag, q_edges, rsum,
                      inv_scale, inv_noise):
    """Device-local per-class sweep tiles: only this device's block
    positions are gathered (the sharded analog of gaussian.sweep_inputs).

    Returns per class (rows_pos [nb, Bloc] pad=B, sites [nb, Bloc] pad=n,
    nbrs, q_blk, P_blk, rs_blk)."""
    n = graph.n
    dtype = pdiag.dtype
    obs_per_loc = jnp.asarray(graph.obs_per_loc)
    out = []
    for ci, (c_sites, c_nbrs, c_edges, c_mask) in enumerate(
        zip(graph.chrom_sites, graph.chrom_nbrs, graph.chrom_edges,
            graph.chrom_nmask)
    ):
        c_sites = jnp.asarray(c_sites)
        B = c_sites.shape[1]
        rows_pos = jnp.asarray(plan.sweep_rows[ci])[d]   # [nb, Bloc], pad=B
        safe_r = jnp.minimum(rows_pos, B - 1)
        realr = rows_pos < B
        sites = jnp.take_along_axis(c_sites, safe_r, axis=1)
        sites = jnp.where(realr, sites, n)
        nbrs = jnp.take_along_axis(jnp.asarray(c_nbrs), safe_r[..., None],
                                   axis=1)
        edges = jnp.take_along_axis(jnp.asarray(c_edges), safe_r[..., None],
                                    axis=1)
        emask = jnp.take_along_axis(jnp.asarray(c_mask), safe_r[..., None],
                                    axis=1) * realr[..., None]
        q_blk = q_edges[edges] * emask
        ss = jnp.minimum(sites, n - 1)
        P_blk = inv_scale * pdiag[ss] + inv_noise * obs_per_loc[ss]
        P_blk = jnp.where(sites < n, P_blk, jnp.ones((), dtype))
        rs_blk = rsum[ss] * (sites < n)
        out.append((rows_pos, sites, nbrs, q_blk, P_blk, rs_blk, B))
    return out


def halo_chromatic_sweeps_local(graph, plan: HaloPlan, w, local_inputs,
                                beta_0, inv_scale, inv_noise, key,
                                n_sweeps: int, d, zero_noise=False,
                                axis=SITES_AXIS):
    """n_sweeps chromatic sweeps over device-local tiles (same global block
    schedule, same per-block keys as gaussian._chromatic_sweeps — the full
    [B] noise vector is drawn and this device's positions selected, so
    draws are bit-identical to the unsharded path)."""
    n = plan.n
    D = plan.D
    dtype = w.dtype

    def one_sweep(sweep, w):
        salt = sweep * 1_000_003
        for ci, (rows_pos, sites, nbrs, q_blk, P_blk, rs_blk, B) in (
            enumerate(local_inputs)
        ):
            nb = sites.shape[0]
            send_tabs = plan.sweep_send[ci]
            dists = plan.sweep_dists[ci]

            def block_step(b, w, rows_pos=rows_pos, sites=sites, nbrs=nbrs,
                           q_blk=q_blk, P_blk=P_blk, rs_blk=rs_blk, B=B,
                           send_tabs=send_tabs, dists=dists, ci=ci):
                kc = jax.random.fold_in(key, salt + ci * 10_007 + b)
                noise_full = jax.random.normal(kc, (B,), dtype=dtype)
                if zero_noise:
                    noise_full = noise_full * 0
                safe = jnp.minimum(rows_pos[b], B - 1)
                prior = jnp.sum(q_blk[b] * (w[nbrs[b]] - beta_0), axis=1)
                Pp = P_blk[b]
                mean = beta_0 - (inv_scale * prior
                                 - inv_noise * rs_blk[b]) / Pp
                val = mean + noise_full[safe] * lax.rsqrt(Pp)
                w = w.at[sites[b]].set(val)
                vals_pad = jnp.concatenate([val, jnp.zeros(1, dtype=dtype)])
                return _exchange(w, vals_pad, send_tabs, dists, d, b, D,
                                 axis)

            w = lax.fori_loop(0, nb, block_step, w)
        return w

    return lax.fori_loop(0, n_sweeps, one_sweep, _varying(w, axis))


def _halo_ancillary(graph, data, cfg, plan, state, linv, mu, key, d, axis,
                    C=None):
    """Block 1 (ref :108-157), sharded: need-rows factor build, owned-rows
    rhs, halo level solve, owned-observation compensated SSE difference."""
    n = graph.n
    k1, k2 = jax.random.split(key)
    innov = _mh_innovation(state, state.tk_ancillary, C, k1,
                           state.field.dtype)
    new_ls = state.log_scale + innov[0]
    new_shape = state.shape + innov[1:]
    natural_new = _natural(cfg, new_shape)
    new_linv = halo_vecchia_linv(graph, plan, natural_new, d)
    owned = jnp.asarray(plan.owned_rows)[d]
    v_vals = rows_linv_mult(linv, state.field - state.beta_0, graph, owned)
    v = jnp.zeros(n + 1, dtype=v_vals.dtype).at[owned].set(v_vals)[:n]
    x = halo_level_solve(graph, plan, new_linv, v, axis=axis)
    new_field = state.beta_0 + exp_acc(0.5 * (new_ls - state.log_scale)) * x
    # compensated SSE difference over owned observations (+psum)
    lm = jnp.asarray(graph.locs_match)
    obs_own = (jnp.asarray(plan.obs_owner) == d).astype(new_field.dtype)
    delta = (new_field - state.field)[lm]
    r_old = data.y - state.field[lm] - mu + state.beta_0
    sse_diff = _psum_df(delta * (delta - 2.0 * r_old) * obs_own, axis)
    llr = -0.5 * exp_acc(-state.log_noise_variance) * sse_diff
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


def _halo_sufficient(graph, data, cfg, plan, state, linv, key, d, axis,
                     C=None):
    """Block 2 (ref :160-213), sharded: per-owned-row loglik difference
    terms + psum (the sharded analog of ops.vecchia.nngp_loglik_diff)."""
    n = graph.n
    k1, k2 = jax.random.split(key)
    innov = _mh_innovation(state, state.tk_sufficient, C, k1,
                           state.field.dtype)
    new_ls = state.log_scale + innov[0]
    new_shape = state.shape + innov[1:]
    natural_new = _natural(cfg, new_shape)
    new_linv = halo_vecchia_linv(graph, plan, natural_new, d)
    owned = jnp.asarray(plan.owned_rows)[d]
    safe = jnp.minimum(owned, n - 1)
    real = (owned < n).astype(state.field.dtype)
    w0 = state.field - state.beta_0
    z_new = rows_linv_mult(new_linv, w0, graph, owned)
    z_old = rows_linv_mult(linv, w0, graph, owned)
    a = jnp.where(real > 0, new_linv[safe, 0], 1.0)
    b = jnp.where(real > 0, linv[safe, 0], 1.0)
    c_new = exp_acc(-new_ls)
    c_old = exp_acc(-state.log_scale)
    terms = (log1p_acc((a - b) / b)
             - 0.5 * (z_new * z_new * c_new - z_old * z_old * c_old)) * real
    gp_ratio = _psum_df(terms, axis) - 0.5 * n * (new_ls - state.log_scale)
    support = ((jnp.exp(new_ls) < data.var_y)
               & _scale_support(data, new_ls)
               & _range_support(cfg, data, natural_new, new_shape))
    accept = support & (
        gp_ratio > jnp.log(jax.random.uniform(k2, dtype=gp_ratio.dtype))
    )
    state = replace(
        state,
        log_scale=jnp.where(accept, new_ls, state.log_scale),
        shape=jnp.where(accept, new_shape, state.shape),
    )
    linv = jnp.where(accept, new_linv, linv)
    return state, linv, accept.astype(linv.dtype)


def _halo_beta(graph, data, cfg, plan, state, linv, key, d, axis):
    """Block 3 (ref :214-250), sharded: owned-rows/owned-obs partial
    crossproducts + psum; replicated draws."""
    n = graph.n
    p = state.beta.shape[0]
    p_locs = len(cfg.locs_cols)
    k1, k2, k3 = jax.random.split(key, 3)
    beta_0, beta, field = state.beta_0, state.beta, state.field
    dtype = field.dtype
    owned = jnp.asarray(plan.owned_rows)[d]
    real = (owned < n).astype(dtype)
    lm = jnp.asarray(graph.locs_match)
    obs_own = (jnp.asarray(plan.obs_owner) == d).astype(dtype)

    if p_locs == 0 or p == 0:
        ones = jnp.ones(n, dtype=dtype)
        L1 = rows_linv_mult(linv, ones, graph, owned) * real
        cov = jnp.exp(state.log_scale) / _psum_df(L1 * L1, axis)
        Lw = rows_linv_mult(linv, field, graph, owned) * real
        mean = jnp.exp(-state.log_scale) * _psum_df(Lw * L1, axis) * cov
        beta_0 = mean + jnp.sqrt(cov) * jax.random.normal(k1, dtype=dtype)

    if p > 0:
        r = (data.y - field[lm] + beta_0) * obs_own
        rX1 = lax.psum(
            jnp.concatenate(
                [jnp.sum(r)[None], jnp.matmul(r, data.X, precision=_HIGHEST)]
            ),
            axis,
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
            ones = jnp.ones((n, 1), dtype=dtype)
            X1l = jnp.concatenate([ones, data.X_locs_u], axis=1)
            LX = rows_linv_mult(linv, X1l, graph, owned) * real[:, None]
            P_iw = lax.psum(jnp.matmul(LX.T, LX, precision=_HIGHEST), axis)
            cL = jnp.linalg.cholesky(P_iw)
            other = field + jnp.matmul(data.X_locs_u, beta[lc],
                                       precision=_HIGHEST)
            Lo = rows_linv_mult(linv, other, graph, owned) * real
            t = lax.psum(jnp.matmul(LX.T, Lo, precision=_HIGHEST), axis)
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


def _halo_noise(graph, data, cfg, plan, state, mu, key, d, axis):
    """Block 5 (ref :277-293), sharded: owned-obs SSE partial + psum."""
    lm = jnp.asarray(graph.locs_match)
    dtype = state.field.dtype
    obs_own = (jnp.asarray(plan.obs_owner) == d).astype(dtype)
    r = (data.y - state.field[lm] - mu + state.beta_0)
    sse = _psum_df(r * r * obs_own, axis)
    n_obs = graph.n_obs

    def body(i, lnv):
        k = jax.random.fold_in(key, i)
        k1, k2 = jax.random.split(k)
        innov = jax.random.normal(k1, dtype=dtype) * 0.01
        ratio = -0.5 * n_obs * innov - 0.5 * sse * exp_acc(-lnv) * jnp.expm1(
            -innov
        )
        ok = (jnp.exp(lnv + innov) < data.var_y) & (
            ratio > jnp.log(jax.random.uniform(k2, dtype=dtype))
        )
        return jnp.where(ok, lnv + innov, lnv)

    lnv = lax.fori_loop(0, cfg.noise_steps, body,
                        _varying(state.log_noise_variance, axis))
    return replace(state, log_noise_variance=lnv)


def halo_gibbs_iteration(graph, data, cfg: UpdateConfig, plan: HaloPlan,
                         carry, xs, axis=SITES_AXIS):
    """One full sharded Gibbs iteration (scan body inside shard_map)."""
    state, linv, acc_anc, acc_suf = carry
    key, it, iter_start = xs
    keys = jax.random.split(key, 6)
    d = lax.axis_index(axis)
    n = graph.n

    mu = _mu_obs(data, state, graph)
    C = _proposal_chol(state)
    am_active = (False if state.prop_mean is None
                 else state.prop_count >= _AM_MIN_COUNT)
    for rep in range(max(1, cfg.covparams_steps)):
        k_anc = jax.random.fold_in(keys[0], rep)
        k_suf = jax.random.fold_in(keys[1], rep)
        if cfg.ancillary:
            state, linv, a = _halo_ancillary(
                graph, data, cfg, plan, state, linv, mu, k_anc, d, axis, C=C)
            acc_anc = acc_anc + a
        state, linv, a = _halo_sufficient(
            graph, data, cfg, plan, state, linv, k_suf, d, axis, C=C)
        acc_suf = acc_suf + a

    window = cfg.adapt_window * max(1, cfg.covparams_steps)
    do_adapt = (it + 1) % cfg.adapt_window == 0
    enabled = iter_start <= cfg.adapt_until
    ka1, ka2 = jax.random.split(keys[2])
    tk_anc = jnp.where(
        do_adapt, _adapt(state.tk_ancillary, acc_anc, ka1, enabled, 0.4,
                         window, am_active), state.tk_ancillary)
    tk_suf = jnp.where(
        do_adapt, _adapt(state.tk_sufficient, acc_suf, ka2, enabled, 0.2,
                         window, am_active), state.tk_sufficient)
    acc_anc = jnp.where(do_adapt, 0.0, acc_anc)
    acc_suf = jnp.where(do_adapt, 0.0, acc_suf)
    state = replace(state, tk_ancillary=tk_anc, tk_sufficient=tk_suf)
    gi = iter_start + it
    # the running moments never freeze (diminishing adaptation: Welford
    # updates shrink as 1/count, preserving ergodicity) and reset twice —
    # halfway through adaptation and at the tk freeze — so the proposal
    # shape converges to the stationary posterior covariance instead of
    # carrying the overdispersed-init drift (which inflates the range
    # direction by orders of magnitude and starves the others).
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

    state = _halo_beta(graph, data, cfg, plan, state, linv, keys[3], d, axis)
    mu = _mu_obs(data, state, graph)

    # block 4: sharded chromatic sweeps
    inv_scale = exp_acc(-state.log_scale)
    inv_noise = exp_acc(-state.log_noise_variance)
    pdiag, q_edges = halo_q_assembly(linv, graph, plan, d)
    rsum = jnp.zeros(n, dtype=state.field.dtype).at[
        jnp.asarray(graph.locs_match)].add(data.y - mu)
    local_inputs = halo_sweep_inputs(
        graph, plan, d, pdiag, q_edges, rsum, inv_scale, inv_noise)
    w1 = jnp.concatenate([state.field,
                          jnp.zeros(1, dtype=state.field.dtype)])
    w = halo_chromatic_sweeps_local(
        graph, plan, w1, local_inputs, state.beta_0, inv_scale, inv_noise,
        keys[4], cfg.n_chromatic, d, zero_noise=cfg.zero_sweep_noise,
        axis=axis)
    w = reconcile(w, jnp.asarray(plan.owner), axis=axis)
    state = replace(state, field=w[:n])

    state = _halo_noise(graph, data, cfg, plan, state, mu, keys[5], d, axis)

    record = {
        "beta_0": state.beta_0,
        "beta": state.beta,
        "log_scale": state.log_scale,
        "log_noise_variance": state.log_noise_variance,
        "shape": state.shape,
    }
    return (state, linv, acc_anc, acc_suf), record


def run_halo_cycle(graph, data, cfg: UpdateConfig, plan: HaloPlan, state,
                   key, iter_start, saved_slots=None, axis=SITES_AXIS):
    """One chain x n_iterations sharded cycle (inside shard_map); mirrors
    gaussian.run_cycle including the in-scan field thinning buffer."""
    d = lax.axis_index(axis)
    linv0 = halo_vecchia_linv(graph, plan, _natural(cfg, state.shape), d)
    keys = jax.random.split(key, cfg.n_iterations)
    its = jnp.arange(cfg.n_iterations)
    starts = jnp.full((cfg.n_iterations,), iter_start)
    zero = state.log_scale * 0
    n_saved = cfg.n_iterations if cfg.n_saved < 0 else cfg.n_saved
    if saved_slots is None:
        saved_slots = jnp.arange(cfg.n_iterations, dtype=jnp.int32)
    else:
        saved_slots = jnp.asarray(saved_slots, dtype=jnp.int32)
    fbuf0 = jnp.zeros((n_saved + 1, graph.n), dtype=state.field.dtype) + zero

    def body(carry, xs):
        inner, fbuf = carry[:-1], carry[-1]
        (_, it, _) = xs
        inner, rec = halo_gibbs_iteration(graph, data, cfg, plan, inner, xs,
                                          axis=axis)
        fbuf = lax.dynamic_update_slice(
            fbuf, inner[0].field[None], (saved_slots[it], 0)
        )
        return inner + (fbuf,), rec

    init = jax.tree.map(lambda x: _varying(x, axis),
                        (state, linv0, zero, zero, fbuf0))
    (state, _, _, _, fbuf), records = lax.scan(body, init,
                                               (keys, its, starts))
    records = dict(records)
    records["field"] = fbuf[:n_saved]
    return state, records


def make_halo_cycle_fn(graph, data, cfg: UpdateConfig, mesh, hplan):
    """(states, keys, iter_start, saved_slots) -> (states', records) over a
    2-D ('chains', 'sites') mesh: states/keys sharded on 'chains',
    everything else replicated, 'sites' collectives inside the body."""
    CH = "chains"

    def body(graph_, data_, plan_, states, keys, iter_start, slots):
        return jax.vmap(
            lambda s, k: run_halo_cycle(graph_, data_, cfg, plan_, s, k,
                                        iter_start, slots)
        )(states, keys)

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P(CH), P(CH), P(), P()),
        out_specs=(P(CH), P(CH)),
        check_vma=False,
    )
    jitted = jax.jit(sharded, donate_argnums=(3,))

    def call(states, keys, iter_start, saved_slots=None):
        if saved_slots is None:
            saved_slots = jnp.arange(cfg.n_iterations, dtype=jnp.int32)
        return jitted(graph, data, hplan, states, keys,
                      jnp.asarray(iter_start),
                      jnp.asarray(saved_slots, dtype=jnp.int32))

    return call
