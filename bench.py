#!/usr/bin/env python
"""Benchmark: ESS/sec on the Heavy-metals workload (the reference's real
workload — Heavy_metals/run_script.R:8-15: n_obs=64,274 lon/lat sites,
14 covariates, exponential_sphere, m=5, 3 chains).

Headline metric (BASELINE.json north star): effective samples per second
for the covariance parameters + latent field, compared against an
R-equivalent baseline.  The baseline is measured, not assumed: a
timing-faithful NumPy/SciPy single-chain implementation of the reference's
per-iteration operations (GpGp::vecchia_Linv -> vectorized batched
Cholesky; Matrix sparse ops -> scipy.sparse CSR; sequential chromatic
color loop with two sparse products per color, mcmc_nngp_update_Gaussian.R
:254-275), which is the same C-backed compute stack R uses.  Both sides run
3 chains (ours vmapped on one chip; R's fork on 3 cores => per-chain
wall-clock = single-chain time), so the ESS/sec ratio equals the
iteration-throughput ratio.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

import json
import os
import sys
import time

import numpy as np


from nngp_tpu.utils.compile_cache import enable_compilation_cache

enable_compilation_cache()


def measure_engine(n_timed_iters=600, n_iterations_update=200, quick=False,
                   n_chains=3, schedule="classed", field_thinning=0.5,
                   warmup_iters=None, warmup_grb=1.1, warmup_max_iters=3200,
                   lean_records=False, smoke=False, window_retries=0,
                   covparams_steps=1):
    import jax

    import nngp_tpu
    from nngp_tpu.diagnostics.ess import effective_size
    from nngp_tpu.diagnostics.grb import Gelman_Rubin_Brooks

    from nngp_tpu.utils.datasets import load_heavy_metals

    locs, y, X = load_heavy_metals()
    if smoke:
        # tiny CI smoke (BENCH_SMOKE=1): exercises every bench path —
        # incl. the lean-record leg — in seconds on CPU
        k = 800
        locs, y = locs[:k], y[:k]
        X = {n: v[:k] for n, v in X.items()}
        n_timed_iters, n_iterations_update = 50, 50
        warmup_max_iters = 50
        warmup_iters = 50 if warmup_iters is None else warmup_iters
    elif quick:
        k = 8000
        locs, y = locs[:k], y[:k]
        X = {n: v[:k] for n, v in X.items()}
        n_timed_iters, n_iterations_update = 200, 100
        warmup_max_iters = 400

    t0 = time.time()
    mc = nngp_tpu.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=n_chains, seed=1,
    )
    setup_s = time.time() - t0

    # GRB-gated warmup (VERDICT r2 item 2): ESS on non-stationary chains is
    # throughput, not effective sampling — warm up until every univariate
    # R-hat < warmup_grb before opening the timed window, and record the
    # R-hat evidence alongside the measurement
    if warmup_iters is None:
        warmup_iters = n_iterations_update
    # lean mode (best-chains leg): record only the 64 monitored field
    # columns in-device (the full-field record is ~111 MB per
    # 100-iteration cycle at 96 chains), and skip the per-cycle GRB/ESS inside
    # the timed window (stationarity is assessed on the window afterwards,
    # and the R baseline's it/s excludes diagnostics too)
    rng = np.random.default_rng(0)
    field_cols = np.sort(rng.choice(mc.graph.n, size=64, replace=False))
    record_cols = field_cols if lean_records else None
    warmed = 0
    rhat_warm = None
    while True:
        mc = nngp_tpu.run(
            mc, n_cycles=1, n_iterations_update=warmup_iters, verbose=False,
            field_thinning=field_thinning,
            Gelman_Rubin_Brooks_stop=(0.0, 0.0), chromatic_schedule=schedule,
            field_record_columns=record_cols,
        )
        warmed += warmup_iters
        if mc.n_chains < 2:
            break
        grb = mc.diagnostics["Gelman_Rubin_Brooks"][-1]
        rhat_warm = float(np.max(grb["R_hat"][1:]))
        print(f"warmup {warmed} iters: max univariate R-hat {rhat_warm:.3f}",
              file=sys.stderr, flush=True)
        if rhat_warm < warmup_grb or warmed >= warmup_max_iters:
            break

    # timed sampling — self-certifying window (VERDICT r4 item 3): the
    # window's OWN univariate R-hats must pass < warmup_grb, not just the
    # warmup-end value; a failing window is demoted to extra warmup and a
    # fresh window is timed (up to window_retries times).  The final
    # verdict travels in `window_stationary`.
    n_cycles = max(1, n_timed_iters // n_iterations_update)
    window_stationary = None
    for attempt in range(window_retries + 1):
        jax.block_until_ready(mc.states.field)
        t0 = time.time()
        mc = nngp_tpu.run(
            mc, n_cycles=n_cycles, n_iterations_update=n_iterations_update,
            verbose=False, field_thinning=field_thinning,
            Gelman_Rubin_Brooks_stop=(0.0, 0.0), chromatic_schedule=schedule,
            field_record_columns=record_cols,
            compute_diagnostics=not lean_records,
            # extra ASIS pairs per iteration in the timed window only
            # (post-adaptation; see models/gaussian.py covparams_steps)
            covparams_steps=covparams_steps,
        )
        jax.block_until_ready(mc.states.field)
        wall = time.time() - t0
        iters_timed = n_cycles * n_iterations_update
        if mc.n_chains < 2:
            break
        g = Gelman_Rubin_Brooks(mc.records,
                                burn_in=1 - iters_timed / mc.iterations)
        worst = float(np.max(g["R_hat"][1:]))
        window_stationary = worst < warmup_grb
        print(f"timed window (attempt {attempt + 1}): max univariate "
              f"R-hat {worst:.3f} -> "
              f"{'stationary' if window_stationary else 'NOT stationary'}",
              file=sys.stderr, flush=True)
        if window_stationary:
            break
    it_per_s = iters_timed / wall  # all chains advance together

    # ESS per iteration from the timed stretch (sum across chains, like the
    # reference's ESS summary row, mcmc_nngp_diagnose.R:116)
    T = mc.iterations
    lo = T - iters_timed
    # recorded width is 64 in lean mode (positional), full n otherwise
    ess_cols = np.arange(64) if lean_records else field_cols
    ess = {"log_scale": 0.0, "log_noise_variance": 0.0, "range": 0.0}
    ess_sq = {k: [] for k in ess}
    field_ess_list = []
    kept_counts = []
    for rec in mc.records:
        for k, series in (
            ("log_scale", rec["log_scale"][lo:T]),
            ("log_noise_variance", rec["log_noise_variance"][lo:T]),
            ("range", rec["shape"][lo:T, 0]),
        ):
            e = effective_size(series)
            ess[k] += e
            ess_sq[k].append(e)
        sf = rec["saved_field"]
        keep = sf > lo
        kept_counts.append(int(keep.sum()))
        f = rec["field"][keep]
        # honest field ESS: ESS of the retained (thinned) series, NOT
        # rescaled to the iteration count (VERDICT r2 weak #3 — near-
        # independent thinned samples would rescale to ~n_iters, an upper
        # bound, not an estimate)
        field_ess_list.append(
            np.mean([effective_size(f[:, c]) for c in ess_cols])
        )
    ess["field_mean"] = float(np.sum(field_ess_list))
    ess_per_iter = {k: v / iters_timed for k, v in ess.items()}
    # MC-error bar of the summed ESS: chain-to-chain spread / sqrt(chains)
    ess_mc_err = {
        k: float(np.std(v) * np.sqrt(len(v))) for k, v in ess_sq.items()
    }
    # R-hat of the timed window itself (stationarity evidence)
    rhat_timed = None
    if mc.n_chains >= 2:
        g = Gelman_Rubin_Brooks(mc.records, burn_in=lo / T)
        rhat_timed = {
            nm: round(float(v), 3)
            for nm, v in zip(g["names"], g["R_hat"])
            if nm in ("Multivariate", "log_scale", "log_noise_variance",
                      "log_range")
        }
    return {
        "setup_s": setup_s,
        "wall_s": wall,
        "iters": iters_timed,
        "n_chains": n_chains,
        "schedule": schedule,
        "it_per_s": it_per_s,
        "ess": ess,
        "ess_mc_err": ess_mc_err,
        "ess_per_iter": ess_per_iter,
        "ess_per_s": {k: v / wall for k, v in ess.items()},
        "field_kept_samples": kept_counts[0] if kept_counts else 0,
        "warmup_iters": warmed,
        "rhat_warmup_end": rhat_warm,
        "rhat_timed_window": rhat_timed,
        "window_stationary": window_stationary,
        "covparams_steps": covparams_steps,
        "n": int(mc.graph.n),
        "backend": jax.default_backend(),
        "lean_records": bool(lean_records),
    }


def measure_r_equivalent_baseline(n_iters=3, quick=False):
    """Single-chain per-iteration time of the reference's operation schedule
    with C-backed NumPy/SciPy (R-equivalent compute stack).

    Per-op audited (VERDICT round-1 item 7): each operation group is timed
    separately, and the sparse triangular solve uses the *fastest* credible
    C-backed candidate measured in-process (scipy spsolve_triangular vs the
    vectorized level-scheduled NumPy solve) so the baseline is the strongest
    honest stand-in for R's Matrix::solve."""
    import time as _time

    from scipy import sparse
    from scipy.sparse.linalg import spsolve_triangular

    from nngp_tpu.preprocess.dedupe import dedupe_and_match
    from nngp_tpu.preprocess.neighbors import find_ordered_nn, nn_mask
    from nngp_tpu.preprocess.ordering import lonlat_to_xyz, reorder_locations
    from nngp_tpu.preprocess.coloring import dag_levels, greedy_coloring
    from nngp_tpu.ops.numpy_ref import np_solve_L
    from nngp_tpu.utils.datasets import load_heavy_metals

    locs, y, X = load_heavy_metals()
    if quick:
        k = 8000
        locs, y = locs[:k], y[:k]
        X = {n: v[:k] for n, v in X.items()}
    maps = dedupe_and_match(
        locs, perm_fn=lambda L: reorder_locations(L, "maxmin", lonlat=True)
    )
    xyz = lonlat_to_xyz(maps.locs)
    m = 5
    NN = find_ordered_nn(maps.locs, m, lonlat=True)
    mask = nn_mask(NN)
    n = len(NN)
    colors = greedy_coloring(NN)
    levels = dag_levels(NN)
    n_colors = colors.max() + 1
    color_sets = [np.where(colors == c)[0] for c in range(n_colors)]
    p_locs = len(X)
    Xl = np.stack([np.asarray(v, dtype=np.float64) for v in X.values()], 1)[
        maps.hctam_scol_1
    ]

    def vecchia_linv_np(rho):
        # batched build, the GpGp::vecchia_Linv equivalent (C-speed via BLAS)
        safe = np.maximum(NN, 0)
        pts = xyz[safe]                                   # [n, m+1, 3]
        diff = pts[:, :, None, :] - pts[:, None, :, :]
        K = np.exp(-np.sqrt((diff * diff).sum(-1)) / rho)
        valid = mask[:, :, None] & mask[:, None, :]
        K = np.where(valid, K, np.eye(m + 1)[None])
        Knn = K[:, 1:, 1:]
        kni = K[:, 1:, 0]
        L = np.linalg.cholesky(Knn)
        u = np.linalg.solve(L, kni[..., None])[..., 0]
        d = np.maximum(K[:, 0, 0] - (u * u).sum(-1), 1e-12)
        b = np.linalg.solve(np.transpose(L, (0, 2, 1)), u[..., None])[..., 0]
        out = np.concatenate([1 / np.sqrt(d)[:, None], -b / np.sqrt(d)[:, None]], 1)
        return out * mask

    def to_csr(linv):
        rows = np.repeat(np.arange(n), mask.sum(1))
        cols = NN[mask]
        return sparse.csr_matrix((linv[mask], (rows, cols)), shape=(n, n))

    w = np.random.default_rng(0).normal(size=n)
    rho = 0.05

    # --- pick the fastest credible triangular solve (audited, not assumed)
    linv_probe = vecchia_linv_np(rho)
    L_probe = to_csr(linv_probe)
    v_probe = L_probe @ w
    t0 = _time.time()
    x_sp = spsolve_triangular(L_probe, v_probe, lower=True)
    t_scipy = _time.time() - t0
    t0 = _time.time()
    x_lv = np_solve_L(linv_probe * mask, NN, v_probe, levels=levels)
    t_level = _time.time() - t0
    assert np.allclose(x_sp, x_lv, atol=1e-8 * max(1, np.abs(x_sp).max()))
    use_level = t_level < t_scipy

    def trisolve(L, linv_rows, v):
        if use_level:
            return np_solve_L(linv_rows * mask, NN, v, levels=levels)
        return spsolve_triangular(L, v, lower=True)

    ops = {"factor_build": 0.0, "trisolve": 0.0, "loglik": 0.0,
           "beta_block": 0.0, "chromatic": 0.0}
    t_all = time.time()
    for _ in range(n_iters):
        # ancillary MH: factor build + sparse trisolve co-transform (ref :123-127)
        t0 = _time.time()
        linv = vecchia_linv_np(rho)
        L = to_csr(linv)
        ops["factor_build"] += _time.time() - t0
        t0 = _time.time()
        v = L @ w
        w_new = trisolve(L, linv, v)
        _ = float(((y[: n] - w_new[: n]) ** 2).sum())
        ops["trisolve"] += _time.time() - t0
        # sufficient MH: factor build + 2x Linv_mult log-lik (ref :179-186)
        t0 = _time.time()
        linv2 = vecchia_linv_np(rho * 1.01)
        L2 = to_csr(linv2)
        ops["factor_build"] += _time.time() - t0
        t0 = _time.time()
        _ = np.log(linv2[:, 0]).sum() - 0.5 * float(((L2 @ w) ** 2).sum())
        _ = np.log(linv[:, 0]).sum() - 0.5 * float(((L @ w) ** 2).sum())
        ops["loglik"] += _time.time() - t0
        # beta block: interweaved precision refresh + draws (ref :147-150, :230-246)
        t0 = _time.time()
        LX = L @ np.concatenate([np.ones((n, 1)), Xl], 1)
        P_iw = LX.T @ LX
        C = np.linalg.inv(P_iw)
        np.linalg.cholesky(C)
        _ = LX.T @ (L @ w)
        ops["beta_block"] += _time.time() - t0
        # chromatic sweeps: 10 x per-color two sparse products (ref :257-274)
        t0 = _time.time()
        pdiag = np.asarray(L.multiply(L).sum(0)).ravel()
        LT = L.T.tocsr()
        for _sweep in range(10):
            for S in color_sets:
                msk = np.ones(n)
                msk[S] = 0.0
                u2 = L @ (w * msk)
                cross = LT[S] @ u2
                P = pdiag[S] + cross * 0 + 1.0
                w[S] = cross / P
        ops["chromatic"] += _time.time() - t0
        # noise MH x10: scalar work on precomputed SSE — negligible (ref :283-293)
    per_iter = (time.time() - t_all) / n_iters
    return {
        "per_iter_s": per_iter,
        "it_per_s": 1.0 / per_iter,
        "n": n,
        "trisolve_impl": "level_numpy" if use_level else "scipy",
        "trisolve_probe_s": {"scipy": round(t_scipy, 3),
                             "level_numpy": round(t_level, 3)},
        "per_op_s": {k: round(v / n_iters, 3) for k, v in ops.items()},
    }


def _excinfo(e):
    import traceback

    return "".join(traceback.format_exception(e)).strip().split("\n")[-3:]


def main():
    import jax

    quick = os.environ.get("BENCH_QUICK") == "1"
    smoke = os.environ.get("BENCH_SMOKE") == "1"
    on_accel = jax.default_backend() != "cpu" and not (quick or smoke)

    # every leg is individually guarded: a failed leg records its error and
    # the bench still prints its one JSON line (VERDICT r3 weak #2 — the
    # round-3 driver bench died with ZeroDivisionError and left no artifact)
    errors = {}

    # 3-chain run = the reference's own protocol (run_script.R:15,
    # n_cores=3)
    eng3 = None
    try:
        eng3 = measure_engine(
            quick=quick, smoke=smoke, n_chains=3,
            n_timed_iters=1000 if on_accel else 600,
            field_thinning=0.5 if not on_accel else 0.1,
            window_retries=2 if on_accel else 0,
        )
    except Exception as e:  # noqa: BLE001
        errors["reference_protocol_3_chains"] = _excinfo(e)
    # many-chains configuration on one device: batched gathers with shared
    # indices amortize across vmapped chains, and ESS/sec sums over chains
    # (the chain count is a setting until it is measured on the card)
    eng_best = None
    if on_accel or smoke:
        try:
            best_chains = int(os.environ.get("BENCH_BEST_CHAINS", "96"))
            best_iters = int(os.environ.get("BENCH_BEST_ITERS", "1500"))
            if smoke:
                best_chains, best_iters = 3, 50
            eng_best = measure_engine(
                n_chains=best_chains, schedule="classed",
                n_timed_iters=best_iters, smoke=smoke,
                n_iterations_update=100, field_thinning=0.05,
                warmup_iters=200 if not smoke else None,
                lean_records=os.environ.get("BENCH_LEAN", "1") == "1",
                window_retries=2 if on_accel else 0,
                covparams_steps=int(os.environ.get("BENCH_K", "3")),
            )
        except Exception as e:  # noqa: BLE001
            errors["best_config"] = _excinfo(e)
    base = None
    try:
        base = measure_r_equivalent_baseline(n_iters=2, quick=quick or smoke)
    except Exception as e:  # noqa: BLE001
        errors["r_equivalent_baseline"] = _excinfo(e)

    def _headline(eng):
        """(engine ESS/s, baseline ESS/s) — zero-guarded: a stuck window or
        empty record yields vs_baseline 0.0, never a ZeroDivisionError."""
        h = min(eng["ess_per_s"]["range"], eng["ess_per_s"]["field_mean"])
        epi = min(eng["ess_per_iter"]["range"],
                  eng["ess_per_iter"]["field_mean"])
        # baseline: same sampler, 3 reference-protocol chains on 3 cores =>
        # per-chain ESS/iter equal by construction; scale our per-chain
        # ESS/iter to 3 baseline chains x measured R-equivalent it/s.
        # When the leg runs covparams_steps=K > 1, the baseline runs the
        # same K (the ASIS-pair multiplier is portable sampler logic) and
        # is charged its own measured per-op prices for the extra pairs:
        # each adds 2 factor builds + a trisolve + a loglik
        # (mcmc_nngp_update_Gaussian.R:108-213 op schedule).
        if base is None:
            return h, None
        K = int(eng.get("covparams_steps", 1) or 1)
        per_iter = 1.0 / base["it_per_s"]
        ops = base.get("per_op_s") or {}
        extra = (ops.get("factor_build", 0.0) + ops.get("trisolve", 0.0)
                 + ops.get("loglik", 0.0))
        base_it_s = 1.0 / (per_iter + (K - 1) * extra)
        base_eps = epi / max(eng["n_chains"], 1) * 3 * base_it_s
        return h, base_eps

    def _ratio(h, b):
        if b is None or not (b > 0.0):
            return 0.0
        return round(float(h / b), 2)

    def _summ(eng):
        return {
            "chains": eng["n_chains"],
            "schedule": eng["schedule"],
            "it_per_s": round(eng["it_per_s"], 2),
            "ms_per_iter": round(1000 / max(eng["it_per_s"], 1e-9), 1),
            "ess_per_s": {k: round(v, 4) for k, v in eng["ess_per_s"].items()},
            "ess_mc_err": {k: round(v, 2) for k, v in eng["ess_mc_err"].items()},
            "timed_iters": eng["iters"],
            "wall_s": round(eng["wall_s"], 1),
            "setup_s": round(eng["setup_s"], 1),
            "warmup_iters": eng["warmup_iters"],
            "rhat_warmup_end": eng["rhat_warmup_end"],
            "rhat_timed_window": eng["rhat_timed_window"],
            "window_stationary": eng["window_stationary"],
            "field_kept_samples": eng["field_kept_samples"],
            "lean_records": eng["lean_records"],
        }

    candidates = [e for e in (eng_best, eng3) if e is not None]
    if not candidates:
        result = {
            "metric": "ESS/sec on Heavy-metals (all legs failed)",
            "value": 0.0, "unit": "ESS/s", "vs_baseline": 0.0,
            "detail": {"errors": errors},
        }
        print(json.dumps(result))
        return
    # headline = best completed leg by measured ESS/s, restricted to legs
    # whose timed window passed its own R-hat gate (VERDICT r4 item 3);
    # non-stationary legs can only headline when no leg passed, and then
    # the window_stationary=False flag travels with the number
    stationary = [e for e in candidates if e["window_stationary"] is not False]
    top = max(stationary or candidates, key=lambda e: _headline(e)[0])
    headline, baseline_ess_per_s = _headline(top)
    detail = {"best_config": _summ(top)}
    for name, eng in (("reference_protocol_3_chains", eng3),
                      ("best_chains_leg", eng_best)):
        if eng is not None and eng is not top:
            h, b = _headline(eng)
            detail[name] = {**_summ(eng), "vs_baseline": _ratio(h, b)}
    if base is not None:
        detail.update({
            "r_equiv_it_per_s": round(base["it_per_s"], 4),
            "baseline_per_op_s": base.get("per_op_s"),
            "baseline_trisolve": {
                "impl": base.get("trisolve_impl"),
                "probe_s": base.get("trisolve_probe_s"),
            },
        })
    if errors:
        detail["errors"] = errors
    result = {
        "metric": "ESS/sec (min of range, latent field) on Heavy-metals "
                  f"n={top['n']}, m=5, {top['n_chains']} chains "
                  f"[{top['backend']}]",
        "value": round(float(headline), 3),
        "unit": "ESS/s",
        "vs_baseline": _ratio(headline, baseline_ess_per_s),
        "detail": detail,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
