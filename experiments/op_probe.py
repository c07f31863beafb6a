"""Isolate the device's error in the sufficient log-ratio against the f64
ratio of the same factors.  Suspects: linv_mult (z = L w row dots with
large cancelling terms), log1p, per-term arithmetic, basic op accuracy.

Run:  python experiments/op_probe.py"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from nngp_tpu.utils.compile_cache import enable_compilation_cache

enable_compilation_cache()

import jax.numpy as jnp
import numpy as np


def main():
    import nngp_tpu
    from nngp_tpu.ops.reductions import pairwise_df_sum
    from nngp_tpu.ops.vecchia import linv_mult, vecchia_linv
    from nngp_tpu.utils.datasets import load_heavy_metals

    backend = jax.default_backend()
    print("backend:", backend, flush=True)
    out = {"backend": backend}

    # --- basic op accuracy on representative magnitudes ---
    rng = np.random.default_rng(0)
    x = np.abs(rng.normal(size=200000)).astype(np.float32) * 300 + 1e-4
    xd = jnp.asarray(x)
    for name, dev, ora in [
        ("div", jax.jit(lambda a: 1.0 / a), lambda a: 1.0 / a),
        ("sqrt", jax.jit(jnp.sqrt), np.sqrt),
        ("rsqrt", jax.jit(jax.lax.rsqrt), lambda a: 1.0 / np.sqrt(a)),
        ("log", jax.jit(jnp.log), np.log),
    ]:
        got = np.asarray(dev(xd), dtype=np.float64)
        want = ora(x.astype(np.float64))
        rel = np.abs(got - want) / np.abs(want)
        out[f"op_{name}_rel"] = {"max": float(rel.max()),
                                 "rms": float(np.sqrt((rel**2).mean()))}
    u = (rng.normal(size=200000) * 0.02).astype(np.float32)
    got = np.asarray(jax.jit(jnp.log1p)(jnp.asarray(u)), dtype=np.float64)
    want = np.log1p(u.astype(np.float64))
    err = np.abs(got - want)
    out["op_log1p_abs"] = {"max": float(err.max())}
    print(json.dumps({k: v for k, v in out.items() if k.startswith("op_")},
                     indent=2), flush=True)

    # --- HM-scale chain: linv rows, z = L w, per-term ratio vector ---
    locs, y, X = load_heavy_metals()
    mc = nngp_tpu.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=1, seed=1,
    )
    g = mc.graph
    n = g.n
    NN = np.asarray(mc.NNarray)
    mask = NN >= 0

    rho, step = 0.03, 0.05
    ls = float(np.log(0.6 * np.var(y)))
    w = (rng.normal(size=n) * np.exp(0.5 * ls)).astype(np.float32)
    wd = jnp.asarray(w)

    lv_old = vecchia_linv(g, jnp.asarray([rho], jnp.float32))
    lv_new = vecchia_linv(g, jnp.asarray([rho * np.exp(step)], jnp.float32))
    lv_old_h = np.asarray(lv_old, dtype=np.float64)
    lv_new_h = np.asarray(lv_new, dtype=np.float64)

    z_dev = np.asarray(jax.jit(lambda l, x: linv_mult(l, x, g))(lv_old, wd),
                       dtype=np.float64)
    # f64 z from the same f32 factors and field
    vals = np.where(mask, w.astype(np.float64)[np.maximum(NN, 0)], 0.0)
    z_64 = (lv_old_h * vals).sum(axis=1)
    dz = z_dev - z_64
    out["z_abs_err"] = {"rms": float(np.sqrt((dz**2).mean())),
                        "max": float(np.abs(dz).max())}
    out["z_scale"] = {"rms": float(np.sqrt((z_64**2).mean()))}
    # row-dot cancellation magnitude
    canc = np.abs(lv_old_h * vals).sum(axis=1)
    out["z_cancellation"] = {"q99": float(np.quantile(canc, 0.99)),
                             "max": float(canc.max())}

    # per-term sufficient-ratio vector, device vs f64-of-device-inputs
    c_old = np.exp(-ls)
    c_new = np.exp(-(ls + step))

    @jax.jit
    def dev_terms(lvn, lvo, x):
        zn = linv_mult(lvn, x, g)
        zo = linv_mult(lvo, x, g)
        a, b = lvn[:, 0], lvo[:, 0]
        terms = (jnp.log1p((a - b) / b)
                 - 0.5 * (zn * zn * np.float32(c_new)
                          - zo * zo * np.float32(c_old)))
        hi, lo = pairwise_df_sum(terms)
        return terms, hi + lo

    terms_dev, s_dev = dev_terms(lv_new, lv_old, wd)
    terms_dev = np.asarray(terms_dev, dtype=np.float64)
    z_new_64 = (lv_new_h * vals).sum(axis=1)
    terms_64 = (np.log(lv_new_h[:, 0] / lv_old_h[:, 0])
                - 0.5 * (z_new_64**2 * c_new - z_64**2 * c_old))
    dt = terms_dev - terms_64
    out["terms_abs_err"] = {"rms": float(np.sqrt((dt**2).mean())),
                            "max": float(np.abs(dt).max()),
                            "sum": float(dt.sum())}
    out["sum_err"] = float(np.float64(s_dev) - terms_64.sum())
    print(json.dumps(out, indent=2))
    with open(f"experiments/op_probe_{backend}.json", "w") as f:
        json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
