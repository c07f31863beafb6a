"""Float-precision audit of the MH log-ratios at Heavy-metals scale.

VERDICT r2 weak #1 hypothesis (a): the ancillary / sufficient MH log-ratios
difference two ~58k-term float32 reductions, so the acceptance test carries
O(0.1-1) state-dependent noise that corrupts the sampler at n=58k while the
n=2000 toy stays clean.

This script measures the *total* error of the f32 device path against a
float64 NumPy oracle (same math, f64 coords, f64 factor build, f64 solve):

  - ancillary log-ratio  (obs-loglik difference after the field co-transform,
    mcmc_nngp_update_Gaussian.R:129-133)
  - sufficient log-ratio (Vecchia GP prior log-density difference, :184-186)
  - decomposition: reduction-only error (f64 summation of the f32-computed
    residuals) vs upstream error (f32 factor build / level solve / coords)

Run (CPU):          python experiments/ratio_audit.py
Run (accelerator):  python experiments/ratio_audit.py --device
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", action="store_true",
                    help="run on JAX's default backend instead of the CPU")
    ap.add_argument("--n-proposals", type=int, default=40)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if not args.device:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import jax
    import jax.numpy as jnp

    import nngp_tpu
    from nngp_tpu.models.gaussian import (
        UpdateConfig, _natural_shape, _obs_sse, _obs_sse_diff,
    )
    from nngp_tpu.ops.numpy_ref import np_shape_transform, np_solve_L, np_sparse_L, np_vecchia_linv
    from nngp_tpu.ops.trisolve import level_solve
    from nngp_tpu.ops.vecchia import linv_mult, nngp_loglik_diff, vecchia_linv
    from nngp_tpu.preprocess.ordering import lonlat_to_xyz
    from nngp_tpu.utils.datasets import load_heavy_metals

    backend = jax.default_backend()
    print(f"backend: {backend}")

    locs, y, X = load_heavy_metals()
    mc = nngp_tpu.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=1, seed=1,
    )
    graph = mc.graph
    n = graph.n
    NN = np.asarray(mc.NNarray)
    names = mc.space_time_model["covfun"]["shape_params"]
    cfg = UpdateConfig(n_iterations=1, shape_names=tuple(names),
                       locs_cols=tuple(mc.design.locs_cols))

    # plausible HM-regime state: theta near expected posterior, field from
    # the prior at that theta (f64 host build, then cast)
    rng = np.random.default_rng(7)
    var_y = float(np.var(y, ddof=1))
    log_scale = float(np.log(0.6 * var_y))
    log_noise = float(np.log(0.35 * var_y))
    shape0 = np.array([np.log(0.03)])  # ~190 km range on the unit sphere
    beta_0 = float(np.mean(y))

    # f64 oracle geometry: recompute sphere coords in float64
    coords64 = lonlat_to_xyz(np.asarray(mc.locs, dtype=np.float64))
    natural0 = np_shape_transform(names, shape0)
    linv0_64 = np_vecchia_linv(coords64, NN, graph.covfun, natural0)
    z = rng.normal(size=n)
    field64 = beta_0 + np.sqrt(np.exp(log_scale)) * np_solve_L(linv0_64, NN, z)

    locs_match = np.asarray(graph.locs_match)
    y64 = np.asarray(y, dtype=np.float64)
    Xd = np.asarray(mc.data.X, dtype=np.float64)
    beta = np.zeros(Xd.shape[1])
    mu64 = beta_0 + Xd @ beta  # beta = 0: mu = beta_0 everywhere

    # device state (f32)
    dtype = np.float32
    field32 = jnp.asarray(field64, dtype=dtype)
    graph_d, data_d = jax.device_put((graph, mc.data))
    shape32 = jnp.asarray(shape0, dtype=dtype)
    mu32 = jnp.full(graph.n_obs, dtype(beta_0))

    @jax.jit
    def f32_ancillary(innov, field, shape, ls):
        linv = vecchia_linv(graph_d, _natural_shape(cfg, shape))
        new_ls = ls + innov[0]
        new_shape = shape + innov[1:]
        new_linv = vecchia_linv(graph_d, _natural_shape(cfg, new_shape))
        v = linv_mult(linv, field - beta_0, graph_d)
        new_field = beta_0 + jnp.exp(0.5 * (new_ls - ls)) * level_solve(
            new_linv, v, graph_d)
        prec = jnp.exp(-log_noise)
        llr = -0.5 * prec * _obs_sse_diff(
            data_d, new_field, field, mu32, beta_0, graph_d
        )
        return llr, new_field

    @jax.jit
    def f32_sufficient(innov, field, shape, ls):
        linv = vecchia_linv(graph_d, _natural_shape(cfg, shape))
        new_ls = ls + innov[0]
        new_shape = shape + innov[1:]
        new_linv = vecchia_linv(graph_d, _natural_shape(cfg, new_shape))
        w0 = field - beta_0
        return nngp_loglik_diff(new_linv, new_ls, linv, ls, w0, graph_d)

    def f64_obs_sse(field, mu):
        r = y64 - field[locs_match] - mu + beta_0
        return float(r @ r)

    def f64_loglik(linv, field, ls):
        L = np_sparse_L(linv, NN)
        zf = L @ field
        return float(np.sum(np.log(linv[:, 0])) - 0.5 * n * ls
                     - 0.5 * (zf @ zf) * np.exp(-ls))

    sse0_64 = f64_obs_sse(field64, mu64)
    print(f"n={n}  var_y={var_y:.4f}  sse0={sse0_64:.1f}  "
          f"prec={np.exp(-log_noise):.3f}")

    tk = -2.0  # proposal log-variance at its initial value
    results = {"backend": backend, "n": n, "anc": [], "suf": [],
               "anc_reduction_only": [], "suf_reduction_only": []}
    t0 = time.time()
    for k in range(args.n_proposals):
        innov = rng.normal(size=2) * np.exp(0.5 * tk)
        innov32 = jnp.asarray(innov, dtype=dtype)

        # ---- ancillary ----
        llr32, nf32 = f32_ancillary(
            innov32, field32, shape32, dtype(log_scale))
        llr32 = float(llr32)
        # f64 oracle
        nat_new = np_shape_transform(names, shape0 + innov[1:])
        linv_new64 = np_vecchia_linv(coords64, NN, graph.covfun, nat_new)
        v64 = np_sparse_L(linv0_64, NN) @ (field64 - beta_0)
        nf64 = beta_0 + np.exp(0.5 * innov[0]) * np_solve_L(linv_new64, NN, v64)
        llr64 = -0.5 * np.exp(-log_noise) * (f64_obs_sse(nf64, mu64) - sse0_64)
        results["anc"].append(llr32 - llr64)
        # reduction-only: f64 sum over the f32-produced field
        sse_new_red = f64_obs_sse(np.asarray(nf32, dtype=np.float64), mu64)
        sse_old_red = f64_obs_sse(np.asarray(field32, dtype=np.float64), mu64)
        llr_mixed = -0.5 * np.exp(-log_noise) * (sse_new_red - sse_old_red)
        results["anc_reduction_only"].append(llr32 - llr_mixed)

        # ---- sufficient ----
        gpr32 = float(f32_sufficient(innov32, field32, shape32, dtype(log_scale)))
        gpr64 = (f64_loglik(linv_new64, field64 - beta_0, log_scale + innov[0])
                 - f64_loglik(linv0_64, field64 - beta_0, log_scale))
        results["suf"].append(gpr32 - gpr64)
        # reduction-only: f64 loglik difference of the f32 factors/field
        linv32o = np.asarray(vecchia_linv(graph_d, jnp.exp(shape32)), dtype=np.float64)
        linv32n = np.asarray(
            vecchia_linv(graph_d, jnp.exp(shape32 + innov32[1:])), dtype=np.float64)
        f32f = np.asarray(field32, dtype=np.float64)
        gpr_mixed = (f64_loglik(linv32n, f32f - beta_0, log_scale + innov[0])
                     - f64_loglik(linv32o, f32f - beta_0, log_scale))
        results["suf_reduction_only"].append(gpr32 - gpr_mixed)

        if k < 5 or (k + 1) % 10 == 0:
            print(f"[{k+1}/{args.n_proposals}] anc_err={results['anc'][-1]:+.4f} "
                  f"(reduction {results['anc_reduction_only'][-1]:+.4f})  "
                  f"suf_err={results['suf'][-1]:+.4f} "
                  f"(reduction {results['suf_reduction_only'][-1]:+.4f})  "
                  f"llr64={llr64:+.3f} gpr64={gpr64:+.3f}", flush=True)

    summary = {}
    for k in ("anc", "suf", "anc_reduction_only", "suf_reduction_only"):
        a = np.asarray(results[k])
        summary[k] = {"rms": float(np.sqrt(np.mean(a * a))),
                      "max_abs": float(np.max(np.abs(a))),
                      "mean": float(np.mean(a))}
    print(json.dumps({"backend": backend, "elapsed_s": round(time.time() - t0, 1),
                      "summary": summary}, indent=2))
    out = args.out or os.path.join(os.path.dirname(__file__),
                                   f"ratio_audit_{backend}.json")
    with open(out, "w") as f:
        json.dump({"backend": backend, "summary": summary,
                   "errors": {k: list(map(float, v)) for k, v in results.items()
                              if isinstance(v, list)}}, f, indent=2)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
