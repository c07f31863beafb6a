"""Pinpoint the device's factor-build error source in the sufficient
log-ratio, against float64.

Decomposition at HM scale, against float64 oracles built from the SAME f32
nn_dist2 inputs (so the geometry is identical and only device arithmetic
differs):

  1. K-entry error: device correlation_from_sqdist vs f64 exp of the same
     f32 d2 (measures the device's exp/div/sqrt accuracy).
  2. Cholesky/conditional-variance error: device vecchia_linv log-diagonal
     vs f64 Cholesky of the DEVICE-computed K (isolates cancellation
     amplification from K-entry error).
  3. End-to-end log-diag error + the distribution of d_i (conditional
     variances) that sets the amplification.
  4. Ratio-relevant: sum over rows of (logd(theta') - logd(theta)) device
     vs f64, for a proposal-sized theta step.

Run:  python experiments/factor_probe.py            (accelerator)
      JAX_PLATFORMS=cpu python experiments/factor_probe.py
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


def f64_linv_from_K(K, mask):
    """f64 oracle of linv_rows_from_K."""
    k = K.shape[-1]
    valid = (mask[:, :, None] * mask[:, None, :]) > 0
    K = np.where(valid, K, np.eye(k)[None])
    Knn = K[:, 1:, 1:]
    kni = K[:, 1:, 0]
    L = np.linalg.cholesky(Knn)
    u = np.linalg.solve(L, kni[..., None])[..., 0]
    d = np.maximum(K[:, 0, 0] - (u * u).sum(-1), 1e-12)
    b = np.linalg.solve(np.transpose(L, (0, 2, 1)), u[..., None])[..., 0]
    out = np.concatenate([1 / np.sqrt(d)[:, None], -b / np.sqrt(d)[:, None]], 1)
    return out * (mask > 0), d


def main():
    import nngp_tpu
    from nngp_tpu.ops.covariance import correlation_from_sqdist
    from nngp_tpu.ops.vecchia import vecchia_linv
    from nngp_tpu.utils.datasets import load_heavy_metals

    backend = jax.default_backend()
    print("backend:", backend)
    locs, y, X = load_heavy_metals()
    mc = nngp_tpu.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=1, seed=1,
    )
    g = mc.graph
    n = g.n
    d2_f32 = np.asarray(g.nn_dist2)            # [n, k, k, 1] f32
    mask = np.asarray(g.nn_mask)

    rho = 0.03
    step = 0.05                                 # proposal-sized log-range step
    out = {"backend": backend, "n": n, "rho": rho}

    dev_K = jax.jit(lambda d2, nat: correlation_from_sqdist(
        "exponential_sphere", d2, nat))
    dev_linv = jax.jit(lambda nat: vecchia_linv(g, nat))

    for tag, r in (("theta", rho), ("theta_prime", rho * np.exp(step))):
        nat32 = jnp.asarray([r], jnp.float32)
        K_dev = np.asarray(dev_K(jnp.asarray(g.nn_dist2), nat32),
                           dtype=np.float64)
        # f64 K from the same f32 d2 (isolates device transcendental error)
        K_64 = np.exp(-np.sqrt(np.maximum(d2_f32[..., 0].astype(np.float64),
                                          0.0)) / np.float64(np.float32(r)))
        ek = np.abs(K_dev - K_64)[mask[:, :, None] * mask[:, None, :] > 0]
        out[f"K_entry_abs_err_{tag}"] = {
            "rms": float(np.sqrt((ek ** 2).mean())), "max": float(ek.max())}

        linv_dev = np.asarray(dev_linv(nat32), dtype=np.float64)
        # f64 Cholesky of the device K: isolates cancellation error
        linv_from_devK, d_devK = f64_linv_from_K(K_dev, mask)
        # full f64 oracle from the f32 d2
        linv_64, d_64 = f64_linv_from_K(K_64, mask)

        logd_dev = np.log(linv_dev[:, 0])
        logd_from_devK = np.log(linv_from_devK[:, 0])
        logd_64 = np.log(linv_64[:, 0])
        chol_err = logd_dev - logd_from_devK     # device Cholesky vs f64 Chol
        kent_err = logd_from_devK - logd_64      # K-entry error through Chol
        tot_err = logd_dev - logd_64
        for nm, e in (("chol", chol_err), ("kentry", kent_err),
                      ("total", tot_err)):
            out[f"logdiag_{nm}_{tag}"] = {
                "rms": float(np.sqrt((e ** 2).mean())),
                "max": float(np.abs(e).max()),
                "sum": float(e.sum()),
            }
        out[f"d_quantiles_{tag}"] = {
            q: float(np.quantile(d_64, qq))
            for q, qq in (("q01", 0.01), ("q10", 0.10), ("q50", 0.50),
                          ("min", 0.0))
        }
        if tag == "theta":
            logd_dev_0, logd_64_0 = logd_dev, logd_64
        else:
            # the ratio term the sufficient MH consumes:
            # sum_i [logd(theta') - logd(theta)], device vs f64
            dev_ratio = (logd_dev - logd_dev_0).sum()
            f64_ratio = (logd_64 - logd_64_0).sum()
            out["logdet_ratio_err"] = float(dev_ratio - f64_ratio)

    print(json.dumps(out, indent=2))
    with open(f"experiments/factor_probe_{backend}.json", "w") as f:
        json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
