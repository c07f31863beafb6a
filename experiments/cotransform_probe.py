"""Pinpoint the device's ancillary co-transform error against float64
(an earlier accelerator showed anc rms ~0.3 upstream of the reduction).

Chain: v = L_old (w - b0)  ->  x = level_solve(L_new, v)  ->
       w' = b0 + e^{dls/2} x ;   llr = -.5 prec * [sse(w') - sse(w)]

Decompose on device vs f64 oracles *from the same f32 factors*:
  a. exp_acc / ldexp accuracy on the device
  b. off-diagonal factor error (device vs f64-from-f32-d2 oracle)
  c. v error (device linv_mult vs f64 of device factors)
  d. x error (device level_solve vs f64 level solve of the same device
     factors and device v)  <- isolates solve arithmetic
  e. x error vs full f64 oracle (factor error included)
  f. the llr impact: -.5 prec * [sse(w'_dev) - sse(w'_oracle)] in f64
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from nngp_tpu.utils.compile_cache import enable_compilation_cache

enable_compilation_cache()

import jax.numpy as jnp
import numpy as np


def np_solve_L_f64(linv, NN, v):
    from nngp_tpu.preprocess.coloring import dag_levels

    NN = np.asarray(NN)
    linv = np.asarray(linv, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    n = NN.shape[0]
    levels = dag_levels(NN)
    mask = NN[:, 1:] >= 0
    parents = np.maximum(NN[:, 1:], 0)
    x = np.zeros(n)
    order = np.argsort(levels, kind="stable")
    bounds = np.searchsorted(levels[order], np.arange(levels.max() + 1))
    bounds = np.append(bounds, n)
    for l in range(levels.max() + 1):
        rows = order[bounds[l]: bounds[l + 1]]
        acc = (linv[rows, 1:] * mask[rows] * x[parents[rows]]).sum(axis=1)
        x[rows] = (v[rows] - acc) / linv[rows, 0]
    return x


def main():
    import nngp_tpu
    from nngp_tpu.ops.covariance import exp_acc
    from nngp_tpu.ops.trisolve import level_solve
    from nngp_tpu.ops.vecchia import linv_mult, vecchia_linv
    from nngp_tpu.ops.numpy_ref import np_vecchia_linv
    from nngp_tpu.preprocess.ordering import lonlat_to_xyz
    from nngp_tpu.utils.datasets import load_heavy_metals

    backend = jax.default_backend()
    print("backend:", backend, flush=True)
    out = {"backend": backend}
    rng = np.random.default_rng(0)

    # a. exp_acc on device
    xs = np.linspace(-5, 5, 100000).astype(np.float32)
    got = np.asarray(jax.jit(exp_acc)(jnp.asarray(xs)), np.float64)
    rel = np.abs(got - np.exp(xs.astype(np.float64))) / np.exp(
        xs.astype(np.float64))
    out["exp_acc_rel_max"] = float(rel.max())

    locs, y, X = load_heavy_metals()
    mc = nngp_tpu.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=1, seed=1,
    )
    g = mc.graph
    n = g.n
    NN = np.asarray(mc.NNarray)
    mask = NN >= 0
    rho, dls = 0.03, 0.05
    ls = float(np.log(0.6 * np.var(y)))
    beta_0 = float(np.mean(y))
    prec = float(np.exp(-np.log(0.35 * np.var(y))))
    w = (beta_0 + rng.normal(size=n) * np.exp(0.5 * ls)).astype(np.float32)
    wd = jnp.asarray(w)

    lv_old = vecchia_linv(g, jnp.asarray([rho], jnp.float32))
    lv_new = vecchia_linv(g, jnp.asarray([rho * 1.02], jnp.float32))
    lvo = np.asarray(lv_old, np.float64)
    lvn = np.asarray(lv_new, np.float64)

    # b. off-diagonal factor error vs f64-from-f32-d2
    d2 = np.asarray(g.nn_dist2)[..., 0].astype(np.float64)
    for tag, r, lv in (("old", rho, lvo), ("new", rho * 1.02, lvn)):
        K64 = np.exp(-np.sqrt(np.maximum(d2, 0)) / np.float64(np.float32(r)))
        valid = mask[:, :, None] & mask[:, None, :]
        K64 = np.where(valid, K64, np.eye(NN.shape[1])[None])
        Knn, kni = K64[:, 1:, 1:], K64[:, 1:, 0]
        L = np.linalg.cholesky(Knn)
        u = np.linalg.solve(L, kni[..., None])[..., 0]
        dd = np.maximum(K64[:, 0, 0] - (u * u).sum(-1), 1e-12)
        b = np.linalg.solve(np.transpose(L, (0, 2, 1)), u[..., None])[..., 0]
        lv64 = np.concatenate(
            [1 / np.sqrt(dd)[:, None], -b / np.sqrt(dd)[:, None]], 1) * mask
        err = np.abs(lv - lv64) / np.maximum(np.abs(lv64), 1e-10)
        out[f"factor_offdiag_rel_{tag}"] = {
            "rms": float(np.sqrt((err[:, 1:][mask[:, 1:]] ** 2).mean())),
            "max": float(err[:, 1:][mask[:, 1:]].max())}
        if tag == "new":
            lvn64 = lv64
        else:
            lvo64 = lv64

    # c. v error
    v_dev = np.asarray(
        jax.jit(lambda l, x: linv_mult(l, x, g))(lv_old, wd - np.float32(beta_0)),
        np.float64)
    vals = np.where(mask, (w - beta_0).astype(np.float64)[np.maximum(NN, 0)], 0)
    v64 = (lvo * vals).sum(1)
    out["v_abs_err"] = {"rms": float(np.sqrt(((v_dev - v64) ** 2).mean())),
                        "max": float(np.abs(v_dev - v64).max())}

    # d. solve arithmetic: device level_solve vs f64 solve of SAME inputs
    x_dev = np.asarray(
        jax.jit(lambda l, v: level_solve(l, v, g))(lv_new, jnp.asarray(
            v_dev, jnp.float32)), np.float64)
    x_same = np_solve_L_f64(lvn, NN, v_dev)
    dx = x_dev - x_same
    out["solve_arith_err"] = {"rms": float(np.sqrt((dx ** 2).mean())),
                              "max": float(np.abs(dx).max())}

    # e. full-chain x vs f64-of-f32-factors oracle
    x_orac = np_solve_L_f64(lvn64, NN, (lvo64 * vals).sum(1))
    dxf = x_dev - x_orac
    out["x_total_err"] = {"rms": float(np.sqrt((dxf ** 2).mean())),
                          "max": float(np.abs(dxf).max())}

    # f. llr impact of the x error
    scale_f = np.exp(0.5 * dls)
    lm = np.asarray(g.locs_match)
    y64 = np.asarray(y, np.float64)

    def sse(field):
        r = y64 - field[lm]
        return r @ r

    w_dev = beta_0 + scale_f * x_dev
    w_orac = beta_0 + scale_f * x_orac
    out["llr_impact_of_x_err"] = float(
        -0.5 * prec * (sse(w_dev) - sse(w_orac)))
    # against the FULL f64 oracle (f64 coords) as the audit does
    coords64 = lonlat_to_xyz(np.asarray(mc.locs, np.float64))
    lv_old_c = np_vecchia_linv(coords64, NN, g.covfun, np.array([rho]))
    lv_new_c = np_vecchia_linv(coords64, NN, g.covfun, np.array([rho * 1.02]))
    vals64 = np.where(mask, (w.astype(np.float64) - beta_0)[np.maximum(NN, 0)], 0)
    x_full = np_solve_L_f64(lv_new_c, NN, (lv_old_c * vals64).sum(1))
    w_full = beta_0 + scale_f * x_full
    out["llr_impact_vs_full_oracle"] = float(
        -0.5 * prec * (sse(w_dev) - sse(w_full)))
    out["x_vs_full_oracle"] = {
        "rms": float(np.sqrt(((x_dev - x_full) ** 2).mean())),
        "max": float(np.abs(x_dev - x_full).max())}

    print(json.dumps(out, indent=2))
    with open(f"experiments/cotransform_probe_{backend}.json", "w") as f:
        json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
