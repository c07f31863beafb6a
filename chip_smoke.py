#!/usr/bin/env python
"""Smoke run of the NNGP sampler's main path on the GPU.

    python chip_smoke.py            # one GPU: device, main path, parity
    python chip_smoke.py --gpus 4   # four GPUs: chains mesh and halo mesh,
                                    # each against the same chains on one GPU

The deployment is the Heavy-metals fit of the reference's
Heavy_metals/run_script.R:8-15 at its full size: 64,274 observations at
58,097 unique lon/lat sites, 14 location covariates, exponential_sphere,
m = 5, 3 chains, field_thinning 0.5, classed chromatic schedule.  The data
are the real ones when the RDS file is in the repository and otherwise the
same-shape synthetic set (repeated sites, a spatial field with the real
fit's covariance; nngp_tpu/utils/datasets.py); the device phase prints
which.

Phases, in order; any failure exits non-zero before the last line:

- device: JAX's first device must be a GPU (never a switch to the CPU).
- main path: initialize -> run (2 cycles x 50 iterations) -> estimate ->
  predict_field on ~1,000 held-out points in the US box.
- parity: each device kernel of that path against the float64 plain
  reference (nngp_tpu/ops/numpy_ref.py) at the same width, under the
  program's own precision settings, each error printed beside its
  tolerance.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.  One process
drives every card it uses.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np

EPS32 = float(np.finfo(np.float32).eps)
US_BOX = ((-125.0, -67.0), (25.0, 49.0))   # lon, lat
# The log-diagonal of the f32 factor build against float64 within 1e-3:
# the bound the repository's own test holds it to
# (tests/test_reductions.py::test_vecchia_linv_uses_f64_distances).
LINV_LOGDIAG_TOL = 1e-3


def card_lines() -> list[str]:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def phase_device(n_gpus: int) -> str:
    import jax

    from nngp_tpu.utils.compile_cache import enable_compilation_cache
    from nngp_tpu.utils.datasets import heavy_metals_source
    from nngp_tpu.utils.native import _load

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"device: JAX's first device is "
                         f"{devices[0].platform!r}, not a GPU")
    if len(devices) < n_gpus:
        raise SystemExit(f"device: {n_gpus} GPUs asked for, JAX sees "
                         f"{len(devices)}")
    cards = card_lines()
    for ln in cards:
        print(f"card: {ln}")
    import jaxlib

    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    print(f"compile cache: {enable_compilation_cache()}")
    print(f"native host library loaded: {_load() is not None}")
    print(f"data source: {heavy_metals_source()}")
    return cards[0]


def heavy_metals_mc(n_chains: int, seed: int = 1):
    import nngp_tpu
    from nngp_tpu.utils.datasets import load_heavy_metals

    locs, y, X = load_heavy_metals()
    return nngp_tpu.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=n_chains, seed=seed,
    )


def check_records(mc, iters: int, n_saved: int):
    n, p = mc.graph.n, mc.design.p
    want = {"beta_0": (iters,), "beta": (iters, p), "log_scale": (iters,),
            "log_noise_variance": (iters,), "shape": (iters, 1),
            "field": (n_saved, n)}
    for i, rec in enumerate(mc.records):
        for k, shp in want.items():
            if rec[k].shape != shp:
                raise AssertionError(f"chain {i} record {k}: shape "
                                     f"{rec[k].shape}, expected {shp}")
            if not np.isfinite(rec[k]).all():
                raise AssertionError(f"chain {i} record {k} not finite")


def phase_main_path(label: str):
    import jax

    import nngp_tpu

    t0 = time.time()
    mc = heavy_metals_mc(n_chains=3)
    setup_s = time.time() - t0
    run_kw = dict(n_cycles=1, n_iterations_update=50, field_thinning=0.5,
                  chromatic_schedule="classed", verbose=False)
    t0 = time.time()
    mc = nngp_tpu.run(mc, **run_kw)
    jax.block_until_ready(mc.states.field)
    first_s = time.time() - t0
    t0 = time.time()
    mc = nngp_tpu.run(mc, **run_kw)
    jax.block_until_ready(mc.states.field)
    second_ms = (time.time() - t0) / 50 * 1000.0

    if mc.iterations != 100:
        raise AssertionError(f"mc.iterations = {mc.iterations}, expected 100")
    for leaf in jax.tree.leaves(mc.states):
        if not np.isfinite(np.asarray(leaf)).all():
            raise AssertionError("non-finite chain state")
    check_records(mc, iters=100, n_saved=50)

    est = nngp_tpu.estimate(mc)
    for k in ("sampled_covparams", "GpGp_covparams", "INLA_covparams"):
        tab = est["covariance_params"][k]["table"]
        if not np.isfinite(tab).all():
            raise AssertionError(f"estimate {k} not finite")
    rng = np.random.default_rng(7)
    pts = np.stack([rng.uniform(*US_BOX[0], 1000),
                    rng.uniform(*US_BOX[1], 1000)], axis=1)
    pred = nngp_tpu.predict_field(mc, pts, m=5)
    summ = pred["predicted_field_summary"]["table"]
    if summ.shape[0] != 1000 or not np.isfinite(summ).all():
        raise AssertionError(f"predict_field summary {summ.shape} not "
                             "finite or wrong size")
    print(f"main path: n={mc.graph.n} sites, {mc.graph.n_obs} obs, "
          f"3 chains, {mc.iterations} iterations, estimate and "
          f"predict_field on {len(pts)} points finite")
    print(f"[{label}] setup {setup_s:.2f} s; first cycle {first_s:.2f} s "
          f"(compile included); second cycle {second_ms:.2f} ms/iter")
    return mc


# ---------------------------------------------------------------- parity


def _f64(x):
    return np.asarray(x, dtype=np.float64)


def _report(name, err, tol):
    ok = bool(np.isfinite(err) and err <= tol)
    print(f"parity {name}: {err:.3e} (tolerance {tol:.3e}) "
          f"{'ok' if ok else 'FAILED'}")
    return ok


def parity_checks(mc, chain: int = 0) -> dict:
    """Each device kernel of the main path against the float64 reference.

    Returns {name: (error, tolerance)}.  The device side runs the program's
    own code with its own precision settings; each reference is computed
    in float64 from the same float32 inputs, so the error is the device's
    own.  Sums on the GPU run in another order than here, and scatter-adds
    are atomic, so every bound is a tolerance, never bit equality.
    """
    from functools import partial

    import jax
    import jax.numpy as jnp

    from nngp_tpu.api import _device_problem
    from nngp_tpu.models.gaussian import (
        UpdateConfig,
        _beta_step,
        _chromatic_sweeps,
        _mu_obs,
        _natural_shape,
    )
    from nngp_tpu.ops.numpy_ref import (
        np_mean_field_sweep,
        np_solve_L,
        np_sparse_L,
        np_vecchia_linv,
    )
    from nngp_tpu.ops.trisolve import level_solve
    from nngp_tpu.ops.vecchia import nngp_loglik_diff, vecchia_linv
    from nngp_tpu.preprocess.ordering import lonlat_to_xyz

    graph, data = _device_problem(mc)
    NN = np.asarray(mc.NNarray)
    n, m1 = NN.shape
    cfg = UpdateConfig(
        n_iterations=1,
        shape_names=tuple(mc.space_time_model["covfun"]["shape_params"]),
        locs_cols=tuple(int(c) for c in mc.design.locs_cols),
        n_chromatic=1, zero_sweep_noise=True,
    )
    state = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)[chain]),
                         mc.states)
    f64 = _f64
    out = {}

    # -- factor build: the f32 build from f64-precomputed distances
    covfun = mc.graph.covfun
    linv_fn = jax.jit(vecchia_linv)
    natural = _natural_shape(cfg, state.shape)
    linv = np.asarray(linv_fn(graph, natural))
    L64 = f64(linv)
    coords = f64(mc.locs)
    if "sphere" in covfun:
        coords = lonlat_to_xyz(coords)
    want = np_vecchia_linv(coords, NN, covfun, f64(natural))
    ldiff = np.log(L64[:, 0]) - np.log(want[:, 0])
    out["vecchia_linv max|log diag ratio|"] = (
        float(np.abs(ldiff).max()), LINV_LOGDIAG_TOL)

    # -- the same, summed: sum_i log linv_i0 is the log-determinant in every
    # MH ratio, so a per-site bias far inside the bound above adds up over
    # n sites (the bound above holds each site's size; this one its sign).
    # Tolerance: the f32 build's per-site errors come from independent
    # roundings (the f32 distances, exp_acc, the Cholesky and solves) of
    # either sign, so given their sizes |d_i| their signs are fair coins
    # and |sum d_i| > 6 sqrt(sum d_i^2) has a chance below 2 exp(-18)
    # (Hoeffding).  The final rsqrt, within 2 ulp and perhaps always of
    # one sign, adds at most 2 n eps.  A bias of b per site adds n b
    # against 6 sqrt(n) b, so 3 ulp at every site fails it.
    out["vecchia_linv |sum log diag ratio|"] = (
        abs(float(ldiff.sum())),
        float(6 * np.sqrt((ldiff ** 2).sum()) + 2 * n * EPS32))

    # -- level-scheduled solve against the same substitution in float64.
    # Tolerance: a first-order forward error bound carried through the
    # DAG.  Row i computes x_i = (v_i - sum_j l_ij x_j) / l_i0: m products
    # and sums in any order plus the division, with slack for a division
    # that is not correctly rounded on the card, so its own error is at
    # most (m+4) eps (|v_i| + sum_j |l_ij x_j|) / |l_i0|; its parents'
    # errors e_j arrive weighted by |l_ij| / |l_i0|.  That recursion is a
    # triangular solve with |L|'s off-diagonal negated.
    rng = np.random.default_rng(11)
    v = rng.normal(size=n).astype(np.float32)
    x = np.asarray(jax.jit(level_solve)(jnp.asarray(linv), jnp.asarray(v),
                                        graph))
    x_ref = np_solve_L(L64, NN, f64(v))
    mask = NN >= 0
    absoff = np.abs(L64[:, 1:]) * mask[:, 1:]
    parents = np.abs(x_ref)[np.maximum(NN[:, 1:], 0)]
    local = (m1 + 3) * EPS32 * (np.abs(f64(v)) + (absoff * parents).sum(1))
    bound_L = np.concatenate([np.abs(L64[:, :1]), -absoff], axis=1)
    e = np_solve_L(bound_L, NN, local)
    scale = np.abs(x_ref).max()
    out["level_solve max|dx|/max|x|"] = (
        float(np.abs(x - x_ref).max() / scale), float(e.max() / scale))

    # -- sufficient-MH log-likelihood difference against float64, from the
    # same two f32 factors (the factor build's own error is checked above),
    # its log-det and quadratic parts each against its own bound.  Each
    # bound has a coherent part, summed over sites in the worst case, for
    # an error every site shares, and a random part for independent
    # roundings of either sign, 6 sqrt(sum of squared per-site bounds)
    # (Hoeffding, as above); the compensated sum adds nothing at this order.
    ls_old = float(state.log_scale)
    ls_new = float(np.float32(ls_old + 0.05))
    linv_new = np.asarray(linv_fn(graph, natural * 1.05))
    Ln64 = f64(linv_new)
    w = np.asarray(state.field - state.beta_0)
    loglik_diff = jax.jit(nngp_loglik_diff)
    # Log-det part: with w = 0 and one log-scale the kernel returns its
    # sum of log1p_acc((a-b)/b) alone.  Per site the subtraction is exact
    # (Sterbenz) and the division one rounding, eps |t_i| at most and
    # random; the log1p polynomial's ~1 ulp is counted as coherent.
    got_ld = float(loglik_diff(
        jnp.asarray(linv_new), jnp.float32(ls_old), jnp.asarray(linv),
        jnp.float32(ls_old), jnp.zeros_like(jnp.asarray(w)), graph))
    t = np.log(Ln64[:, 0]) - np.log(L64[:, 0])
    want_ld = float(t.sum())
    out["nngp_loglik_diff log-det part |d|"] = (
        abs(got_ld - want_ld),
        float(EPS32 * (np.abs(t).sum() + 6 * np.sqrt((t * t).sum())
                       + abs(want_ld))))
    # Quadratic part: the full difference less the log-det part.  Per site
    # z_i is an (m+1)-term product, off by (m+1) eps s_i with s_i =
    # sum_j |l_ij w_j|, so c z_i^2 / 2 by (m+4) eps c (|z_i| + s_i)^2 / 2
    # at most, with its own roundings; c = exp_acc(-log_scale) is ~1 ulp
    # off for every site at once; the log-scale term and the two f32
    # results add a rounding each.
    got_q = float(loglik_diff(
        jnp.asarray(linv_new), jnp.float32(ls_new), jnp.asarray(linv),
        jnp.float32(ls_old), jnp.asarray(w), graph)) - got_ld
    Ln, Lo = np_sparse_L(linv_new, NN), np_sparse_L(linv, NN)
    zn, zo = Ln @ f64(w), Lo @ f64(w)
    cn, co = np.exp(-ls_new), np.exp(-ls_old)
    const = 0.5 * n * (ls_new - ls_old)
    want_q = -0.5 * (zn @ zn * cn - zo @ zo * co) - const
    wabs = np.abs(f64(w))
    q_site = 0.5 * (m1 + 3) * EPS32 * (
        cn * (np.abs(zn) + abs(Ln) @ wabs) ** 2
        + co * (np.abs(zo) + abs(Lo) @ wabs) ** 2)
    out["nngp_loglik_diff quadratic part |d|"] = (
        abs(got_q - want_q),
        float(EPS32 * (0.5 * (cn * (zn @ zn) + co * (zo @ zo)) + abs(const)
                       + abs(want_q + want_ld) + abs(want_ld))
              + 6 * np.sqrt((q_site ** 2).sum())))

    # -- fixed-effect mean mu = beta_0 + X beta.  Tolerance: a (p+1)-term
    # dot in float32, (p+1) eps times the sum of |terms|; a TF32 product
    # (10-bit mantissa) would be off by ~2^-11 of the terms and fail it.
    X64 = f64(data.X)
    mu = np.asarray(jax.jit(_mu_obs)(data, state, graph))
    b0, beta = float(state.beta_0), f64(state.beta)
    mu_ref = b0 + X64 @ beta
    mu_mag = abs(b0) + np.abs(X64) @ np.abs(beta)
    out["_mu_obs max|d|/sum|terms|"] = (
        float(np.max(np.abs(mu - mu_ref) / mu_mag)),
        float((X64.shape[1] + 1) * EPS32))

    # -- beta block: with both proposal scales driven to e^-300 its draws
    # collapse to their means, so _beta_step returns the conditional mean
    # of (beta_0, beta) with the interweaved (location-indexed) redraw.
    # Tolerance: the precision and its right-hand side are n-length sums
    # whose float32 rounding grows like sqrt(n) eps in any blocked order;
    # the small solve amplifies relative error by at most cond(P_iw).
    quiet = replace(state, log_scale=jnp.float32(-300.0),
                    log_noise_variance=jnp.float32(-300.0))
    beta_fn = jax.jit(partial(_beta_step, cfg=cfg))
    bs = beta_fn(graph, data, state=quiet, linv=jnp.asarray(linv),
                 key=jax.random.key(0))
    got_b = np.concatenate([[float(bs.beta_0)], np.asarray(bs.beta)])
    want_b, cond = _np_beta_mean(mc, state, L64, NN, cfg)
    out["_beta_step mean |d|/|mean|"] = (
        float(np.linalg.norm(got_b - want_b) / np.linalg.norm(want_b)),
        float(8 * cond * np.sqrt(n) * EPS32))

    # -- one zero-noise chromatic sweep per schedule against the float64
    # mean-field map walking the same block order (the two schedules walk
    # different Gibbs orders, so they are not compared with each other).
    # Tolerance: a first-order forward error bound carried along the walk.
    # A site's mean sums at most D neighbor terms and the residual sum,
    # then scales and divides: D + 6 roundings relative to the magnitudes
    # summed.  An error carried by an earlier-updated neighbor j arrives
    # weighted by e^-ls |Q_sj| / P_s.
    lm = np.asarray(mc.graph.locs_match)
    resid = f64(data.y) - f64(mu)
    rsum = np.zeros(n)
    np.add.at(rsum, lm, resid)
    rabs = np.zeros(n)
    np.add.at(rabs, lm, np.abs(resid))
    D = int(np.asarray(mc.graph.nbr_sites).shape[1])
    for schedule in ("classed", "flat"):
        scfg = replace(cfg, chromatic_schedule=schedule)
        sweep = jax.jit(partial(_chromatic_sweeps, cfg=scfg))
        got_w = np.asarray(sweep(graph, data, state=state,
                                 linv=jnp.asarray(linv), mu=jnp.asarray(mu),
                                 key=jax.random.key(1)).field)
        if schedule == "flat":
            blocks = list(np.asarray(mc.graph.chrom_blocks))
        else:
            blocks = [r for t in mc.graph.chrom_sites for r in np.asarray(t)]
        want_w = np_mean_field_sweep(
            L64, NN, blocks, f64(state.field), b0, float(state.log_scale),
            float(state.log_noise_variance), rsum,
            f64(mc.graph.obs_per_loc))
        bound = _sweep_error_bound(
            L64, NN, blocks, np.maximum(np.abs(f64(state.field) - b0),
                                        np.abs(want_w - b0)),
            abs(b0), float(state.log_scale),
            float(state.log_noise_variance), rabs,
            f64(mc.graph.obs_per_loc), (D + 6) * EPS32)
        out[f"sweep[{schedule}] max|dw|"] = (
            float(np.abs(got_w - want_w).max()), float(bound.max()))
    return out


def _sweep_error_bound(L64, NN, blocks, wdev_abs, b0_abs, log_scale,
                       log_noise_variance, rabs, obs_per_loc, rel):
    """Worst-case first-order error of one sweep: per block,
    e_s = rel * mag_s + e^-ls (|Q_off| e)_s / P_s, where mag_s =
    |beta_0| + (e^-ls (|Q_off| |w - beta_0|)_s + e^-lnv sum|r|_s) / P_s."""
    from scipy import sparse

    from nngp_tpu.ops.numpy_ref import np_sparse_L

    n = NN.shape[0]
    L = np_sparse_L(L64, NN)
    Q = (L.T @ L).tocsr()
    qdiag = Q.diagonal()
    Qabs = abs(Q - sparse.diags(qdiag)).tocsr()
    inv_scale = np.exp(-log_scale)
    inv_noise = np.exp(-log_noise_variance)
    P = inv_scale * qdiag + inv_noise * obs_per_loc
    mag = b0_abs + (inv_scale * (Qabs @ wdev_abs) + inv_noise * rabs) / P
    e = np.zeros(n)
    for blk in blocks:
        s = np.asarray(blk)
        s = s[s < n]
        e[s] = rel * mag[s] + inv_scale * (Qabs[s] @ e) / P[s]
    return e


def _np_beta_mean(mc, state, L64, NN, cfg):
    """Float64 replica of _beta_step's means (mcmc_nngp_update_Gaussian.R
    :226-246): the non-centered conjugate mean of (beta_0, beta), then the
    interweaved centered mean of (beta_0, beta[locs]).  Returns the mean
    vector and cond(P_iw)."""
    from nngp_tpu.ops.numpy_ref import np_sparse_L

    d = mc.data
    f64 = _f64
    lm = np.asarray(mc.graph.locs_match)
    field, b0 = f64(state.field), float(state.beta_0)
    r = f64(d.y) - field[lm] + b0
    X = f64(d.X)
    bmean = np.concatenate([[r.sum()], r @ X]) @ f64(d.solve_1XT1X)
    field = field - b0 + bmean[0]
    beta = bmean[1:].copy()
    lc = np.asarray(cfg.locs_cols, dtype=np.int64)
    Xl = f64(d.X_locs_u)
    L = np_sparse_L(L64, NN)
    LX = L @ np.concatenate([np.ones((len(field), 1)), Xl], axis=1)
    P = LX.T @ LX
    other = field + Xl @ beta[lc]
    mean = np.linalg.solve(P, LX.T @ (L @ other))
    beta[lc] = mean[1:]
    return np.concatenate([[mean[0]], beta]), float(np.linalg.cond(P))


def phase_parity(mc) -> None:
    checks = parity_checks(mc)
    failed = [k for k, (err, tol) in checks.items() if not _report(k, err, tol)]
    if failed:
        raise AssertionError(f"parity failed: {failed}")


# ------------------------------------------------------------ four GPUs


def _fresh_copy(mc):
    """The same initialized fit with its own records, states and caches."""
    return replace(mc, records=copy.deepcopy(mc.records),
                   states=copy.deepcopy(mc.states), diagnostics={
                       "Gelman_Rubin_Brooks": [], "ESS": []},
                   _cycle_cache={})


def _tracking(mc, ref, iters):
    """Chains whose records follow the reference run's.  Reductions run
    in another order on every mesh (and scatter-adds are atomic), so a
    trajectory matches only to rounding — until an MH decision whose
    log-ratio lies within that rounding of its uniform draw flips, after
    which the chain rightly goes its own way.  Scalars within 5e-3 and
    the last kept field within 2e-2, as tests/test_halo_run.py holds the
    sharded run on the CPU."""
    good = []
    for a, b in zip(mc.records, ref.records):
        ok = all(np.allclose(a[k][:iters], b[k][:iters], rtol=0, atol=5e-3)
                 for k in ("beta_0", "log_scale", "log_noise_variance",
                           "shape"))
        good.append(ok and np.allclose(a["field"][-1], b["field"][-1],
                                       rtol=0, atol=2e-2))
    return good


def _spread(tree, mesh):
    import jax

    want = set(mesh.devices.flat)
    return all(set(leaf.sharding.device_set) == want
               for leaf in jax.tree.leaves(tree))


def phase_four_gpus(label: str, n_chains: int = 8, iters: int = 25):
    import jax
    from jax.sharding import Mesh

    import nngp_tpu
    from nngp_tpu.api import _device_problem, _get_halo_plan
    from nngp_tpu.parallel.chains import chains_mesh

    devices = jax.devices()[:4]
    t0 = time.time()
    base = heavy_metals_mc(n_chains=n_chains)
    print(f"four GPUs: setup {time.time() - t0:.2f} s, n={base.graph.n}, "
          f"{n_chains} chains, {iters} iterations per run")
    run_kw = dict(n_cycles=1, n_iterations_update=iters, field_thinning=0.5,
                  verbose=False, Gelman_Rubin_Brooks_stop=(0.0, 0.0))
    meshes = {
        "one GPU": None,
        "chains mesh (4)": chains_mesh(devices),
        "halo mesh (2 chains x 2 sites)": Mesh(
            np.asarray(devices).reshape(2, 2), ("chains", "sites")),
    }
    runs = {}
    for name, mesh in meshes.items():
        mc = _fresh_copy(base)
        t0 = time.time()
        mc = nngp_tpu.run(mc, mesh=mesh, **run_kw)
        jax.block_until_ready(mc.states.field)
        wall = time.time() - t0
        check_records(mc, iters=iters, n_saved=iters // 2)
        runs[name] = mc
        print(f"[{label}] {name}: {wall:.2f} s for {iters} iterations "
              "(compile included)")
        if mesh is None:
            continue
        placed = [("problem", _device_problem(mc, mesh)),
                  ("states", mc.states)]
        if "sites" in mesh.axis_names:
            placed.append(("halo plan", _get_halo_plan(mc, mesh)))
        for what, tree in placed:
            if not _spread(tree, mesh):
                raise AssertionError(f"{name}: {what} not on every device "
                                     "of the mesh")
        good = _tracking(mc, runs["one GPU"], iters)
        print(f"{name}: {sum(good)} of {n_chains} chains track the one-GPU "
              f"run; problem, states"
              f"{' and halo plan' if 'sites' in mesh.axis_names else ''} "
              "on all of its devices")
        if sum(good) < n_chains - 1:
            raise AssertionError(f"{name}: only {sum(good)} of {n_chains} "
                                 "chains track the one-GPU run")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-GPU phase")
    args = ap.parse_args(argv)

    card = phase_device(args.gpus)
    import jax

    if args.gpus == 4:
        phase_four_gpus(card)
    else:
        mc = phase_main_path(card)
        phase_parity(mc)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
