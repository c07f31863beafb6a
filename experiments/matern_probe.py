"""Matérn factor-build probe on the current backend (VERDICT r4 item 2 /
missing #1): the round-3 probe battery (experiments/factor_probe.py) for
the matern_isotropic / matern_sphere families, against float64 oracles.

The Matérn kernel evaluates lgamma, log, exp and K_nu inside the
conditional-variance amplification zone (1/d_i reaches 1e2-1e5 at
Heavy-metals geometry), so any builtin's few-ulp error is amplified — the
exact mechanism that produced the round-2 silent divergence for the
exponential families.  Measured here, at HM geometry (n=58k,
matern_sphere) and a synthetic isotropic layout:

  1. K-entry error: device correlation_from_sqdist vs f64 scipy.special
     (same f32 d2 inputs, so only device arithmetic differs).
  2. log-diag error of the factor: device vecchia_linv vs the f64
     Cholesky pipeline applied to the DEVICE K (isolates cancellation
     amplification) and to the f64 K (end-to-end).
  3. Proposal-sized sufficient-ratio ingredient: sum_i dlog d_i between
     theta and a proposal theta', device vs f64 (the quantity whose error
     enters the MH log-ratio).

Run:  python experiments/matern_probe.py                      (accelerator)
      JAX_PLATFORMS=cpu python experiments/matern_probe.py

Reference: matern families registry mcmc_nngp_initialize.R:66-69,
smoothness transform mcmc_nngp_update_Gaussian.R:70.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from nngp_tpu.utils.compile_cache import enable_compilation_cache

enable_compilation_cache()

import jax.numpy as jnp
import numpy as np
from scipy.special import gamma as sp_gamma, kv as sp_kv


def f64_matern_from_d2g(d2g, ranges, nu):
    """f64 oracle of correlation_from_sqdist for a matern family."""
    d2 = (d2g.astype(np.float64) / (np.asarray(ranges, np.float64) ** 2)).sum(-1)
    d = np.sqrt(np.maximum(d2, 0.0))
    safe = np.maximum(d, 1e-8)
    val = (2.0 ** (1.0 - nu) / sp_gamma(nu)) * safe**nu * sp_kv(nu, safe)
    return np.where(d <= 1e-8, 1.0, val)


def f64_linv_logdiag(K, mask, d_floor=1e-5):
    """f64 oracle of the factor log-diagonal, with the same family-aware
    conditional-variance floor as the device build (VecchiaGraph.d_floor —
    the floored model IS the target after the round-5 fix)."""
    k = K.shape[-1]
    valid = (mask[:, :, None] * mask[:, None, :]) > 0
    K = np.where(valid, K.astype(np.float64), np.eye(k)[None])
    Knn = K[:, 1:, 1:]
    kni = K[:, 1:, 0]
    L = np.linalg.cholesky(Knn)
    u = np.linalg.solve(L, kni[..., None])[..., 0]
    d = np.maximum(K[:, 0, 0] - (u * u).sum(-1), d_floor)
    return -0.5 * np.log(d), d


def probe_family(covfun, graph, NN, label, out):
    from nngp_tpu.ops.covariance import correlation_from_sqdist
    from nngp_tpu.ops.vecchia import vecchia_linv

    n = graph.n
    d2g = np.asarray(graph.nn_dist2)       # f32 host copy, f64-built
    mask = np.asarray(graph.nn_mask)
    # posterior-plausible theta: range ~ 5% of typical nn distance scale,
    # smoothness mid-band (nu = 0.75 <-> qlogis 0)
    med_d = float(np.sqrt(np.median(d2g.sum(-1)[mask > 0][d2g.sum(-1)[mask > 0] > 0])))
    G = d2g.shape[-1]
    # posterior-realistic range: the converged HM fit sits at ~2.5x the
    # median neighbor distance (experiments/slow_direction_diag.json:
    # range 0.0060 vs med nn dist 2.45e-3)
    rho = med_d * 2.5
    natural = np.array([rho] * G + [0.75], dtype=np.float64)
    natural_p = np.array([rho * 1.02] * G + [0.7525], dtype=np.float64)
    print(f"[{label}] n={n} median nn dist {med_d:.2e}, range {rho:.3e}, "
          f"nu 0.75", flush=True)

    dev = {}
    for nm, nat in (("theta", natural), ("theta_p", natural_p)):
        K_dev = np.asarray(jax.jit(
            lambda d2, s: correlation_from_sqdist(covfun, d2, s)
        )(jnp.asarray(d2g), jnp.asarray(nat, jnp.float32)))
        linv_dev = np.asarray(jax.jit(
            lambda s: vecchia_linv(graph, s)
        )(jnp.asarray(nat, jnp.float32)))
        dev[nm] = (K_dev, linv_dev)

    K_dev, linv_dev = dev["theta"]
    # 1. K-entry error
    K_f64 = f64_matern_from_d2g(d2g, natural[:G], natural[G])
    valid = (mask[:, :, None] * mask[:, None, :]) > 0
    kerr = np.abs(K_dev - K_f64)[valid]
    # 2. log-diag error
    ld_dev = np.log(linv_dev[:, 0])
    ld_oracle_devK, d_devK = f64_linv_logdiag(K_dev, mask)
    ld_oracle_f64K, d_f64K = f64_linv_logdiag(K_f64, mask)
    e_chol = ld_dev - ld_oracle_devK       # device chol vs f64 chol, same K
    e_total = ld_dev - ld_oracle_f64K      # end-to-end
    # 3. proposal-sized log-det difference
    K_dev_p, linv_dev_p = dev["theta_p"]
    K_f64_p = f64_matern_from_d2g(d2g, natural_p[:G], natural_p[G])
    dld_dev = np.log(linv_dev_p[:, 0]) - np.log(linv_dev[:, 0])
    ld_p64, _ = f64_linv_logdiag(K_f64_p, mask)
    dld_f64 = ld_p64 - ld_oracle_f64K
    ratio_err = float(dld_dev.sum() - dld_f64.sum())
    # error concentration: how much of the ratio error lives in the
    # near-singular rows (d below threshold)?
    row_err = dld_dev - dld_f64
    conc = {}
    for thr in (1e-3, 1e-4, 1e-5):
        sel = d_f64K < thr
        conc[f"d<{thr:g}"] = {
            "rows": int(sel.sum()),
            "err_sum": float(row_err[sel].sum()),
            "err_abs_sum": float(np.abs(row_err[sel]).sum()),
        }
    conc["all"] = {"rows": int(len(row_err)),
                   "err_abs_sum": float(np.abs(row_err).sum())}

    entry = {
        "covfun": covfun, "n": int(n), "range": rho, "nu": 0.75,
        "K_entry_err": {"max": float(kerr.max()),
                        "rms": float(np.sqrt((kerr**2).mean()))},
        "cond_var_d": {"min": float(d_f64K.min()),
                       "p1": float(np.percentile(d_f64K, 1)),
                       "median": float(np.median(d_f64K))},
        "logdiag_err_vs_devK": {"max": float(np.abs(e_chol).max()),
                                "sum": float(e_chol.sum())},
        "logdiag_err_total": {"max": float(np.abs(e_total).max()),
                              "sum": float(e_total.sum())},
        "proposal_logdet_diff_err": ratio_err,
        "proposal_logdet_diff_f64": float(dld_f64.sum()),
        "ratio_err_concentration": conc,
    }
    out[label] = entry
    print(json.dumps(entry, indent=1), flush=True)


def main():
    import nngp_tpu  # noqa: F401
    from nngp_tpu.preprocess.dedupe import dedupe_and_match
    from nngp_tpu.preprocess.graph import build_graph
    from nngp_tpu.preprocess.ordering import reorder_locations
    from nngp_tpu.utils.datasets import load_heavy_metals

    backend = jax.default_backend()
    print("backend:", backend, flush=True)
    out = {"backend": backend}

    # HM geometry, matern_sphere
    locs, y, X = load_heavy_metals()
    rng = np.random.default_rng(1)
    maps = dedupe_and_match(
        locs, perm_fn=lambda L: reorder_locations(L, "maxmin", lonlat=True,
                                                  rng=rng))
    graph, NN = build_graph(maps, m=5, covfun="matern_sphere")
    probe_family("matern_sphere", graph, NN, "hm_matern_sphere", out)

    # synthetic isotropic layout (clustered points -> small d_i tail)
    rng2 = np.random.default_rng(2)
    base = rng2.uniform(0, 100, size=(20_000, 2))
    jitter = base[rng2.integers(0, len(base), 20_000)] + rng2.normal(
        size=(20_000, 2)) * 0.05
    locs2 = np.concatenate([base, jitter])
    maps2 = dedupe_and_match(
        locs2, perm_fn=lambda L: reorder_locations(L, "maxmin", rng=rng2))
    graph2, NN2 = build_graph(maps2, m=5, covfun="matern_isotropic")
    probe_family("matern_isotropic", graph2, NN2, "synthetic_matern_iso", out)

    path = (f"experiments/matern_probe_{backend}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path, flush=True)


if __name__ == "__main__":
    main()
