"""Public API mirroring the reference entry points.

- initialize : mcmc_nngp_initialize (Scripts/mcmc_nngp_initialize.R)
- run        : mcmc_nngp_run        (Scripts/mcmc_nngp_run.R)
- estimate   : mcmc_nngp_estimate   (Scripts/mcmc_nngp_estimate.R)
- predict_*  : mcmc_nngp_predict_*  (Scripts/mcmc_nngp_predict.R)
- save/load  : saveRDS/readRDS on the self-contained fit object
               (Heavy_metals/run_script.R:17)

The returned ``MCMC`` object is the analog of the reference's
``mcmc_nngp_list`` (mcmc_nngp_initialize.R:237-239): an immutable problem
spec (graph, design, data) plus mutable {states, records, diagnostics};
``run`` can be re-invoked any number of times to continue sampling — the
same checkpoint/resume contract as the reference (SURVEY.md §5).
"""

from __future__ import annotations

import pickle
import time
from dataclasses import dataclass, field as dc_field

import jax
import jax.numpy as jnp
import numpy as np

from nngp_tpu.diagnostics.ess import ESS as _ESS
from nngp_tpu.diagnostics.grb import Gelman_Rubin_Brooks as _GRB
from nngp_tpu.models.gaussian import (
    ChainState,
    ModelData,
    UpdateConfig,
    make_cycle_fn,
)
from nngp_tpu.ops.covariance import shape_param_names
from nngp_tpu.preprocess.dedupe import dedupe_and_match
from nngp_tpu.preprocess.design import Design, build_design
from nngp_tpu.preprocess.graph import VecchiaGraph, build_graph
from nngp_tpu.preprocess.ordering import reorder_locations


@dataclass
class MCMC:
    """Self-contained fit object (the reference's mcmc_nngp_list)."""

    locs: np.ndarray
    observed_locs: np.ndarray
    observed_field: np.ndarray
    graph: VecchiaGraph
    design: Design
    data: ModelData
    space_time_model: dict
    states: ChainState            # stacked pytree, leading axis = chains
    records: list                 # per-chain dicts of numpy arrays
    diagnostics: dict
    n_chains: int
    seed: int
    t_begin: float
    NNarray: np.ndarray
    # active lean-record column set (None = full-field records); persisted
    # so a resumed run cannot silently mix column sets (ADVICE r3)
    field_record_columns: tuple | None = None
    _cycle_cache: dict = dc_field(default_factory=dict, repr=False)

    @property
    def iterations(self) -> int:
        return int(self.records[0]["iterations"][-1][0])


def _stack_states(states_list):
    return jax.tree.map(lambda *xs: np.stack(xs), *states_list)


def _build_model_data(observed_field, design, X_locs_u, dtype, range_cap,
                      range_floor=None):
    return ModelData(
        y=np.asarray(observed_field, dtype=dtype),
        X=np.asarray(design.X if design.X is not None else
                     np.zeros((len(observed_field), 0)), dtype=dtype),
        X_locs_u=np.asarray(X_locs_u, dtype=dtype),
        solve_1XT1X=np.asarray(design.solve_1XT1X, dtype=dtype)
        if design.solve_1XT1X is not None else np.zeros((1, 1), dtype=dtype),
        chol_solve_1XT1X_lower=np.asarray(
            design.chol_solve_1XT1X.T, dtype=dtype)
        if design.chol_solve_1XT1X is not None else np.zeros((1, 1), dtype=dtype),
        var_y=np.asarray(np.var(observed_field, ddof=1), dtype=dtype),
        range_cap=np.asarray(range_cap, dtype=dtype),
        range_floor=(None if range_floor is None
                     else np.asarray(range_floor, dtype=dtype)),
    )


def _range_floor_from_graph(graph) -> np.ndarray:
    """Per-range-group lower support: median nearest-parent distance / 100
    (ModelData.range_floor rationale) — [G] aligned with the log_* shape
    parameters."""
    d2 = np.asarray(graph.nn_dist2, dtype=np.float64)   # [n, k, k, G]
    has_parent = np.asarray(graph.nn_mask)[:, 1] > 0 if d2.shape[1] > 1 \
        else np.zeros(d2.shape[0], dtype=bool)
    out = []
    for g in range(d2.shape[-1]):
        dp = d2[has_parent, 0, 1, g]
        dp = dp[dp > 0]
        med = np.sqrt(np.median(dp)) if len(dp) else 0.0
        out.append(med / 100.0)
    return np.asarray(out)


def _range_cap_from_coords(coords) -> float:
    """4x the bounding-box diagonal of the kernel coordinates: an upper
    bound on 4x the domain diameter (see ModelData.range_cap)."""
    c = np.asarray(coords, dtype=np.float64)
    diag = float(np.sqrt(((c.max(0) - c.min(0)) ** 2).sum()))
    return 4.0 * max(diag, 1e-30)


def _replicated(mesh):
    """Sharding that places a read-only pytree on every device of ``mesh``
    (None: the default device)."""
    if mesh is None:
        return None
    from jax.sharding import NamedSharding, PartitionSpec

    return NamedSharding(mesh, PartitionSpec())


def _device_problem(mc: "MCMC", mesh=None):
    """One batched host->device transfer of the static problem pytree,
    replicated over ``mesh`` when one is given (so a sharded cycle does not
    re-broadcast it from one device on every call)."""
    key = ("__device_problem__", mesh)
    cached = mc._cycle_cache.get(key)
    if cached is None:
        cached = jax.device_put((mc.graph, mc.data), _replicated(mesh))
        mc._cycle_cache[key] = cached
    return cached


def initialize(
    observed_locs,
    observed_field,
    X_obs=None,
    X_locs=None,
    m: int = 10,
    reordering="maxmin",
    stationary_covfun: str = "exponential_isotropic",
    response_model: str = "Gaussian",
    n_chains: int = 3,
    seed: int = 1,
    dtype=np.float32,
) -> MCMC:
    """Build the model state (mcmc_nngp_initialize.R:1-240).

    Reordering/dedupe/NN-search/coloring run on the host once; the
    per-chain overdispersed initial states match the reference's recipes
    (:143-209) distributionally.
    """
    t_begin = time.time()
    if response_model != "Gaussian":
        raise ValueError("only the Gaussian response model is implemented "
                         "(matching the reference, mcmc_nngp_initialize.R:170)")
    rng = np.random.default_rng(seed)
    observed_locs = np.asarray(observed_locs, dtype=np.float64)
    observed_field = np.asarray(observed_field, dtype=np.float64)
    lonlat = "sphere" in stationary_covfun

    maps = dedupe_and_match(
        observed_locs,
        perm_fn=lambda L: reorder_locations(L, reordering, lonlat=lonlat, rng=rng),
    )
    graph, NN = build_graph(maps, m=m, covfun=stationary_covfun, dtype=dtype)
    n = graph.n
    n_dims = observed_locs.shape[1]
    names = shape_param_names(stationary_covfun, n_dims)

    design = build_design(X_locs=X_locs, X_obs=X_obs)
    p = design.p
    # location covariates at unique locations (first-obs representative row)
    h1 = np.asarray(graph.hctam_scol_1)
    if design.p_locs > 0:
        X_locs_u = design.X[h1][:, design.locs_cols]
    else:
        X_locs_u = np.zeros((n, 0))
    data = _build_model_data(observed_field, design, X_locs_u, dtype,
                             _range_cap_from_coords(graph.kernel_coords),
                             _range_floor_from_graph(graph))

    # --- per-chain overdispersed initial states (ref :143-209) ---
    # OLS anchor for the regression coefficients (ref :173)
    n_obs = len(observed_field)
    if p > 0:
        X1 = np.concatenate([np.ones((n_obs, 1)), design.X], axis=1)
    else:
        X1 = np.ones((n_obs, 1))
    coef, *_ = np.linalg.lstsq(X1, observed_field, rcond=None)
    resid = observed_field - X1 @ coef
    dof = max(n_obs - X1.shape[1], 1)
    sigma2_hat = float(resid @ resid) / dof
    vcov = sigma2_hat * np.linalg.inv(X1.T @ X1)
    vcov_chol = np.linalg.cholesky(vcov)
    var_resid = float(np.var(resid, ddof=1))

    # shape inits: log(max dist among first 100 reordered locs) - log U{20..200}
    # per range parameter (ref :152-161).  Deviation from the reference:
    # for *_sphere families the distance is measured in KERNEL coordinates
    # (unit-sphere chordal), not raw lon/lat degrees — the reference's raw
    # dist() puts sphere inits ~(180/pi)x beyond the domain, deep in the
    # flat unidentifiable zone (slow burn-in at many chains; the r3 NaN
    # region before the range_cap).  The intent — a U{20..200} fraction of
    # the domain size — is preserved in the units the kernel actually uses.
    locs100 = maps.locs[: min(100, n)]
    kc100 = np.asarray(graph.kernel_coords, dtype=np.float64)[: min(100, n)]

    def _maxdist(cols):
        sub = kc100 if cols is None else locs100[:, cols]
        if sub.ndim == 1:
            sub = sub[:, None]
        d = np.sqrt(((sub[:, None] - sub[None]) ** 2).sum(-1))
        return d.max()

    def _draw_range(cols):
        return np.log(_maxdist(cols)) - np.log(rng.integers(20, 201))

    # Per-chain prior field simulation is a one-shot host computation; done
    # in float64 NumPy/SciPy (ops.numpy_ref) rather than as many small eager
    # device ops.  States transfer to the accelerator at the first jitted
    # cycle.
    from nngp_tpu.ops.numpy_ref import (
        np_shape_transform,
        np_solve_L,
        np_vecchia_linv,
    )

    coords_np = np.asarray(graph.kernel_coords, dtype=np.float64)

    states_list = []
    for _ in range(n_chains):
        shape0 = []
        for nm in names:
            if nm.startswith("qlogis"):
                shape0.append(rng.normal())
            elif stationary_covfun.endswith("scaledim"):
                j = len(shape0)
                shape0.append(_draw_range([j]))
            elif stationary_covfun.endswith("spacetime"):
                if len(shape0) == 0:
                    shape0.append(_draw_range(list(range(n_dims - 1))))
                else:
                    shape0.append(_draw_range([n_dims - 1]))
            else:
                shape0.append(_draw_range(None))
        shape0 = np.array(shape0)
        perturb = vcov_chol @ rng.normal(size=X1.shape[1])
        beta_0 = coef[0] + perturb[0]
        beta = coef[1:] + perturb[1:]
        log_scale = float(np.log(rng.beta(10, 10) * var_resid))
        log_noise = float(np.log(rng.beta(10, 10) * var_resid))
        # field ~ prior (ref :196-208): beta_0 + sqrt(scale) L^-1 z
        natural = np_shape_transform(names, shape0)
        linv = np_vecchia_linv(coords_np, NN, stationary_covfun, natural)
        z = rng.normal(size=n)
        fld = beta_0 + np.sqrt(np.exp(log_scale)) * np_solve_L(linv, NN, z)
        d_am = 1 + len(names)
        states_list.append(
            ChainState(
                beta_0=np.asarray(beta_0, dtype=dtype),
                beta=np.asarray(beta, dtype=dtype),
                log_scale=np.asarray(log_scale, dtype=dtype),
                log_noise_variance=np.asarray(log_noise, dtype=dtype),
                shape=np.asarray(shape0, dtype=dtype),
                field=np.asarray(fld, dtype=dtype),
                tk_ancillary=np.asarray(-2.0, dtype=dtype),
                tk_sufficient=np.asarray(-2.0, dtype=dtype),
                # adaptive-covariance proposal accumulators (Welford), see
                # models/gaussian.py ChainState docs
                prop_mean=np.zeros(d_am, dtype=dtype),
                prop_m2=np.zeros((d_am, d_am), dtype=dtype),
                prop_count=np.asarray(0.0, dtype=dtype),
            )
        )

    records = []
    for _ in range(n_chains):
        records.append(
            {
                "iterations": [(0, time.time() - t_begin)],
                "saved_field": np.zeros(0, dtype=np.int64),
                "beta_0": np.zeros((0,)),
                "beta": np.zeros((0, p)) if p else None,
                "beta_names": list(design.names),
                "log_scale": np.zeros((0,)),
                "log_noise_variance": np.zeros((0,)),
                "shape": np.zeros((0, len(names))),
                "shape_names": list(names),
                "field": np.zeros((0, n)),
            }
        )

    mc = MCMC(
        locs=maps.locs,
        observed_locs=observed_locs,
        observed_field=observed_field,
        graph=graph,
        design=design,
        data=data,
        space_time_model={
            "response_model": response_model,
            "covfun": {
                "stationary_covfun": stationary_covfun,
                "shape_params": names,
            },
        },
        states=_stack_states(states_list),
        records=records,
        diagnostics={"Gelman_Rubin_Brooks": [], "ESS": []},
        n_chains=n_chains,
        seed=seed,
        t_begin=t_begin,
        NNarray=NN,
    )
    print(f"Setup done, {time.time() - t_begin:.2f} s elapsed")
    return mc


def _get_halo_plan(mc: MCMC, mesh):
    key = ("__halo_plan__", mesh)
    plan = mc._cycle_cache.get(key)
    if plan is None:
        from nngp_tpu.parallel.halo import build_halo_plan

        plan = jax.device_put(
            build_halo_plan(mc.graph, int(mesh.shape["sites"])),
            _replicated(mesh),
        )
        mc._cycle_cache[key] = plan
    return plan


def _get_cycle_fn(mc: MCMC, cfg: UpdateConfig, mesh=None):
    key = (cfg, id(mesh))
    fn = mc._cycle_cache.get(key)
    if fn is None:
        graph_d, data_d = _device_problem(mc, mesh)
        if mesh is not None and "sites" in mesh.axis_names:
            # halo mode: chains x sites 2-D mesh — the full iteration runs
            # sharded by site ownership (parallel/halo_gibbs.py); the sweep
            # schedule is the classed one (its tables drive the halo plan)
            from nngp_tpu.parallel.halo_gibbs import make_halo_cycle_fn

            hplan = _get_halo_plan(mc, mesh)
            fn = make_halo_cycle_fn(graph_d, data_d, cfg, mesh, hplan)
            mc._cycle_cache[key] = fn
            return fn
        if mesh is None:
            fn = make_cycle_fn(graph_d, data_d, cfg)
        else:
            from nngp_tpu.parallel.chains import make_sharded_cycle_fn

            fn = make_sharded_cycle_fn(graph_d, data_d, cfg, mesh)
        mc._cycle_cache[key] = fn
    return fn


def run(
    mc: MCMC,
    Gelman_Rubin_Brooks_stop=(1.1, 1.1),
    burn_in: float = 0.5,
    field_thinning: float = 1.0,
    n_iterations_update: int = 200,
    ancillary: bool = True,
    n_chromatic: int = 10,
    n_cycles: int = 1,
    save_name: str | None = None,
    plot_beta: bool = False,
    verbose: bool = True,
    mesh=None,
    plot_trace: str | None = None,
    log_jsonl: str | None = None,
    profile_dir: str | None = None,
    chromatic_schedule: str = "classed",
    n_cores=None,  # accepted for reference-signature parity; chains are
                   # device-parallel here (mcmc_nngp_run.R:3)
    max_device_iters: int | None = None,
    field_record_columns=None,
    compute_diagnostics: bool = True,
    covparams_steps: int = 1,
) -> MCMC:
    """Cycle loop with per-cycle diagnostics and early stop
    (mcmc_nngp_run.R:1-52).  All chains advance together in one vmapped
    device computation per cycle; honors the ``ancillary`` flag (accepted
    but ignored by the reference — mcmc_nngp_update_Gaussian.R:14-19).

    Pass ``mesh`` (a 1-D jax.sharding.Mesh with a 'chains' axis) to shard
    the chains over multiple devices/hosts; n_chains must divide evenly.

    ``field_record_columns`` (sorted site indices) records only those
    columns of each kept field snapshot — cuts the device->host record
    pull, which grows as chains x snapshots x n, for monitoring/ESS
    workflows; the full field is still sampled every iteration, only the
    *record* is subsampled (estimation/prediction from the records then
    see just those columns).  ``compute_diagnostics=False`` skips the per-cycle
    GRB/ESS computation (the early-stop rule is then inert), for timed
    windows where diagnostics are measured separately.

    By default a cycle is one device call.  ``max_device_iters`` splits it
    into sub-calls of at most that many iterations (rounded down to a
    multiple of the 25-iteration adaptation window, so the sampled chain
    is unchanged).
    """
    import os as _os
    from dataclasses import replace as _dc_replace

    if max_device_iters is None:
        max_device_iters = int(n_iterations_update)
    else:
        max_device_iters = max(25, (int(max_device_iters) // 25) * 25)

    def _sub_lengths(total):
        out = []
        while total > 0:
            L = min(max_device_iters, total)
            out.append(L)
            total -= L
        return out

    if chromatic_schedule not in ("classed", "flat"):
        raise ValueError(
            f"unknown chromatic_schedule {chromatic_schedule!r}: expected "
            "'classed' or 'flat' (the 'mxu' and 'pallas' schedules were "
            "removed — see docs/scaling.md post-mortems)"
        )
    field_cols = None
    prev_cols = getattr(mc, "field_record_columns", None)
    have_records = any(rec["field"].shape[0] > 0 for rec in mc.records)
    if field_record_columns is not None:
        if mesh is not None and "sites" in mesh.axis_names:
            raise ValueError(
                "field_record_columns is not supported in halo (sites-"
                "sharded) mode: record columns are global site indices "
                "while each device holds a local field shard"
            )
        field_cols = tuple(int(c) for c in np.asarray(field_record_columns))
        # refuse any mid-chain change of the recorded column *identities*
        # (not just the width — same-size different-site sets would silently
        # concatenate samples of different sites, ADVICE r3 medium)
        if prev_cols is not None and tuple(prev_cols) != field_cols:
            raise ValueError(
                "field_record_columns changed mid-chain: records were "
                f"previously taken at {len(prev_cols)} fixed columns; "
                "resume with the same column set or start a new fit"
            )
        if prev_cols is None and have_records:
            raise ValueError(
                "field_record_columns changed mid-chain: existing records "
                "hold full-width field snapshots; column subsampling can "
                "only start on a fresh fit"
            )
        # existing (empty) records carry full-field width from initialize;
        # re-key them to the recorded width (keeping the record dtype)
        for rec in mc.records:
            if rec["field"].shape[1] != len(field_cols):
                rec["field"] = np.zeros(
                    (0, len(field_cols)), dtype=rec["field"].dtype
                )
        mc.field_record_columns = field_cols
        for rec in mc.records:
            rec["field_columns"] = np.asarray(field_cols, dtype=np.int64)
    elif prev_cols is not None:
        if have_records:
            raise ValueError(
                "field_record_columns changed mid-chain: existing records "
                f"are column-subsampled ({len(prev_cols)} columns); pass "
                "the same field_record_columns to continue, or start a new "
                "fit for full-field recording"
            )
        for rec in mc.records:
            rec["field"] = np.zeros((0, mc.graph.n), dtype=rec["field"].dtype)
            rec.pop("field_columns", None)
        mc.field_record_columns = None
    cfg = UpdateConfig(
        n_iterations=int(n_iterations_update),
        shape_names=tuple(mc.space_time_model["covfun"]["shape_params"]),
        locs_cols=tuple(int(c) for c in mc.design.locs_cols),
        n_chromatic=int(n_chromatic),
        ancillary=bool(ancillary),
        chromatic_schedule=chromatic_schedule,
        field_cols=field_cols,
        covparams_steps=int(covparams_steps),
    )
    if mesh is not None:
        from nngp_tpu.parallel.chains import shard_states

        n_chain_dev = (int(mesh.shape["chains"]) if "chains" in mesh.axis_names
                       else mesh.size)
        if mc.n_chains % n_chain_dev != 0:
            raise ValueError(
                f"n_chains={mc.n_chains} must be divisible by the chains "
                f"mesh axis ({n_chain_dev})"
            )
        mc.states = shard_states(mc.states, mesh)
    base_key = jax.random.key(mc.seed)

    # When nothing inside the loop consumes host-side records (diagnostics
    # off, no checkpointing/plots/logs), defer every device->host record
    # pull to the end of the call: each sub-call's record arrays stay on
    # device and the next sub-call is dispatched immediately, so JAX's
    # async dispatch overlaps the pulls with device compute.  Record
    # contents are identical either way.
    defer_pull = (not compute_diagnostics and save_name is None
                  and plot_trace is None and log_jsonl is None)
    pending_recs = []

    def _append_records(recs_host, saved, cycle_start):
        for i in range(mc.n_chains):
            rec = mc.records[i]
            rec["beta_0"] = np.concatenate(
                [rec["beta_0"], recs_host["beta_0"][i]])
            if rec["beta"] is not None:
                rec["beta"] = np.concatenate(
                    [rec["beta"], recs_host["beta"][i]])
            rec["log_scale"] = np.concatenate(
                [rec["log_scale"], recs_host["log_scale"][i]])
            rec["log_noise_variance"] = np.concatenate(
                [rec["log_noise_variance"],
                 recs_host["log_noise_variance"][i]])
            rec["shape"] = np.concatenate(
                [rec["shape"], recs_host["shape"][i]])
            rec["field"] = np.concatenate(
                [rec["field"], recs_host["field"][i]])
            rec["saved_field"] = np.concatenate(
                [rec["saved_field"], cycle_start + saved])

    import contextlib

    profiler_ctx = contextlib.nullcontext()
    if profile_dir is not None:
        profiler_ctx = jax.profiler.trace(profile_dir)

    with profiler_ctx:
      for cycle in range(1, n_cycles + 1):
        if verbose:
            print(f"cycle = {cycle}")
        t_cycle = time.time()
        cycle_start = mc.iterations
        offset = 0
        for L in _sub_lengths(cfg.n_iterations):
            iter_start = cycle_start + offset
            # field thinning happens inside the device scan: iteration i of
            # this sub-call writes its field snapshot to saved_slots[i] of a
            # [n_saved, n] buffer (slot n_saved = discard).  Thinning
            # positions are relative to the enclosing cycle (the reference's
            # round(it*t)==it*t rule, mcmc_nngp_update_Gaussian.R:56)
            it = offset + np.arange(1, L + 1)
            saved = it[np.round(it * field_thinning) == it * field_thinning]
            n_saved = len(saved)
            slots = np.full(L, n_saved, dtype=np.int32)
            slots[saved - offset - 1] = np.arange(n_saved, dtype=np.int32)
            sub_cfg = _dc_replace(cfg, n_iterations=L, n_saved=n_saved)
            cycle_fn = _get_cycle_fn(mc, sub_cfg, mesh)
            # per-(call, chain) keys, the analog of set.seed(iter_start + i)
            # (mcmc_nngp_update_Gaussian.R:36)
            ck = jax.random.fold_in(base_key, iter_start)
            keys = jax.vmap(lambda i: jax.random.fold_in(ck, i))(
                jnp.arange(mc.n_chains)
            )
            _timing = _os.environ.get("NNGP_TIMING") == "1"
            t_sub = time.time()
            states, recs = cycle_fn(
                mc.states, keys, jnp.asarray(iter_start, dtype=jnp.int32),
                jnp.asarray(slots),
            )
            mc.states = states
            if _timing:
                np.asarray(jnp.sum(jnp.asarray(recs["log_scale"])))
                t_dev = time.time() - t_sub
            recs = dict(recs)
            if defer_pull:
                pending_recs.append((recs, saved, cycle_start))
            else:
                recs = jax.device_get(recs)
                if _timing:
                    print(f"[timing] sub-call L={L}: device={t_dev:.2f}s "
                          f"pull={time.time() - t_sub - t_dev:.2f}s",
                          flush=True)
                _append_records(recs, saved, cycle_start)
            offset += L
        for i in range(mc.n_chains):
            mc.records[i]["iterations"].append(
                (cycle_start + cfg.n_iterations, time.time() - mc.t_begin)
            )

        # trace plots each cycle when requested (mcmc_nngp_run.R:36-37;
        # headless: written to files under plot_trace)
        if plot_trace is not None:
            import os

            from nngp_tpu.diagnostics.plots import (
                raw_chains_plots_beta,
                raw_chains_plots_covparms,
            )

            os.makedirs(plot_trace, exist_ok=True)
            raw_chains_plots_covparms(
                mc.records, burn_in,
                path=os.path.join(plot_trace, "trace_covparms.png"),
            )
            if plot_beta:
                raw_chains_plots_beta(
                    mc.records, burn_in,
                    path=os.path.join(plot_trace, "trace_beta.png"),
                )

        # diagnostics + early stop (mcmc_nngp_run.R:36-46)
        grb = None
        t_diag = time.time()
        if compute_diagnostics and mc.n_chains >= 2:
            grb = _GRB(mc.records, burn_in)
            ess = _ESS(mc.records, burn_in)
            mc.diagnostics["Gelman_Rubin_Brooks"].append(grb)
            mc.diagnostics["ESS"].append(ess)
            if verbose:
                with np.printoptions(precision=3, suppress=True):
                    print("Gelman-Rubin-Brooks R-hat : ")
                    print(dict(zip(grb["names"], np.round(grb["R_hat"], 3))))
        if _os.environ.get("NNGP_TIMING") == "1":
            print(f"[timing] cycle {cycle}: total={time.time() - t_cycle:.2f}s"
                  f" diagnostics={time.time() - t_diag:.2f}s", flush=True)
        if log_jsonl is not None:
            import json

            entry = {
                "cycle": cycle,
                "iteration": mc.iterations,
                "elapsed_s": round(time.time() - mc.t_begin, 3),
                "cycle_s": round(time.time() - t_cycle, 3),
            }
            if grb is not None:
                entry["R_hat"] = dict(
                    zip(grb["names"], np.round(grb["R_hat"], 4).tolist())
                )
            with open(log_jsonl, "a") as f:
                f.write(json.dumps(entry) + "\n")
        if save_name:
            save(mc, save_name)
        if grb is not None and (
            grb["R_hat"][0] < Gelman_Rubin_Brooks_stop[0]
            or np.all(grb["R_hat"][1:] < Gelman_Rubin_Brooks_stop[1])
        ):
            break
    # drain the deferred device->host record pulls (defer_pull path): all
    # sub-calls have been dispatched, so these pulls overlap the tail of
    # device compute instead of serializing with each dispatch
    for recs_d, saved_d, cs_d in pending_recs:
        _append_records(jax.device_get(recs_d), saved_d, cs_d)
    pending_recs.clear()
    return mc


def estimate(mc: MCMC, burn_in: float = 0.5):
    from nngp_tpu.estimation import mcmc_nngp_estimate

    return mcmc_nngp_estimate(mc, burn_in)


def predict_field(mc: MCMC, predicted_locs, burn_in: float = 0.5, m: int = 10,
                  sample_chunk: int = 64, n_cores=None):
    from nngp_tpu.prediction import mcmc_nngp_predict_field

    return mcmc_nngp_predict_field(mc, predicted_locs, burn_in, m, sample_chunk)


def predict_fixed_effects(mc: MCMC, X_predicted, burn_in: float = 0.5,
                          match_field_thinning: bool = True,
                          add_intercept: bool = False, n_cores=None):
    from nngp_tpu.prediction import mcmc_nngp_predict_fixed_effects

    return mcmc_nngp_predict_fixed_effects(
        mc, X_predicted, burn_in, match_field_thinning, add_intercept
    )


def save(mc: MCMC, path: str) -> None:
    """Serialize the whole fit (analog of saveRDS, run_script.R:17)."""
    host = {
        "locs": mc.locs,
        "observed_locs": mc.observed_locs,
        "observed_field": mc.observed_field,
        "space_time_model": mc.space_time_model,
        "records": mc.records,
        "diagnostics": mc.diagnostics,
        "n_chains": mc.n_chains,
        "seed": mc.seed,
        "t_begin": mc.t_begin,
        "NNarray": mc.NNarray,
        "states": jax.tree.map(np.asarray, mc.states),
        "design": mc.design,
        "m": mc.NNarray.shape[1] - 1,
        # observation<->location maps: persisting these (plus NNarray above)
        # lets load() rebuild the graph deterministically instead of
        # re-matching locations by exact float equality (VERDICT r2 #6)
        "locs_match": np.asarray(mc.graph.locs_match),
        "hctam_scol_1": np.asarray(mc.graph.hctam_scol_1),
        "obs_per_loc": np.asarray(mc.graph.obs_per_loc),
        "field_record_columns": getattr(mc, "field_record_columns", None),
    }
    with open(path, "wb") as f:
        pickle.dump(host, f)


def load(path: str) -> MCMC:
    """Rebuild a fit object saved with :func:`save` (readRDS analog)."""
    with open(path, "rb") as f:
        host = pickle.load(f)
    covfun = host["space_time_model"]["covfun"]["stationary_covfun"]
    if "locs_match" in host:
        # saved index maps + saved NNarray: deterministic rebuild, no
        # float matching involved (VERDICT r2 #6)
        from nngp_tpu.preprocess.dedupe import ObsMaps

        maps = ObsMaps(
            locs=np.asarray(host["locs"]),
            locs_match=np.asarray(host["locs_match"]),
            hctam_scol_1=np.asarray(host["hctam_scol_1"]),
            obs_per_loc=np.asarray(host["obs_per_loc"]),
        )
        graph, NN = build_graph(maps, m=host["m"], covfun=covfun,
                                NN=host["NNarray"])
    else:  # legacy pickles (pre round-3)
        maps = dedupe_and_match(
            host["observed_locs"],
            perm_fn=lambda L: _match_permutation(L, host["locs"]),
        )
        graph, NN = build_graph(maps, m=host["m"], covfun=covfun)
    design = host["design"]
    # rebuild ModelData
    n = graph.n
    h1 = np.asarray(graph.hctam_scol_1)
    dtype = np.float32
    if design.p_locs > 0:
        X_locs_u = design.X[h1][:, design.locs_cols]
    else:
        X_locs_u = np.zeros((n, 0))
    data = _build_model_data(host["observed_field"], design, X_locs_u, dtype,
                             _range_cap_from_coords(graph.kernel_coords),
                             _range_floor_from_graph(graph))
    return MCMC(
        locs=host["locs"],
        observed_locs=host["observed_locs"],
        observed_field=host["observed_field"],
        graph=graph,
        design=design,
        data=data,
        space_time_model=host["space_time_model"],
        states=jax.tree.map(np.asarray, host["states"]),
        records=host["records"],
        diagnostics=host["diagnostics"],
        n_chains=host["n_chains"],
        seed=host["seed"],
        t_begin=host["t_begin"],
        NNarray=host["NNarray"],
        field_record_columns=host.get("field_record_columns"),
    )


def _match_permutation(deduped_locs, target_locs):
    """Permutation mapping first-occurrence-deduped locs onto a saved
    ordering (used when reloading a fit)."""
    key = {tuple(row): i for i, row in enumerate(np.asarray(target_locs))}
    order = np.array([key[tuple(r)] for r in np.asarray(deduped_locs)])
    perm = np.empty(len(order), dtype=np.int64)
    perm[order] = np.arange(len(order))
    return perm
