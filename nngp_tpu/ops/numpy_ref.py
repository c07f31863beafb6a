"""NumPy reference implementations of the core kernels.

Used for (a) one-shot host-side computations where paying an accelerator
compile round-trip is wasteful (per-chain prior field simulation at
initialize time, mcmc_nngp_initialize.R:196-208), and (b) as C-speed
oracles/baselines (bench.py's R-equivalent measurement).  Mirrors
ops/covariance.py and ops/vecchia.py semantics exactly.
"""

from __future__ import annotations

import numpy as np
import scipy.special
from scipy import sparse


def np_shape_transform(names, sampled):
    out = []
    for j, nm in enumerate(names):
        if nm.startswith("log"):
            out.append(np.exp(sampled[j]))
        elif nm.startswith("qlogis"):
            out.append(0.5 + 0.5 / (1.0 + np.exp(-sampled[j])))
        else:
            raise ValueError(nm)
    return np.asarray(out)


def np_correlation(covfun, coords, natural):
    """[..., k, d'] -> [..., k, k] correlation, matching ops.covariance."""
    kind = covfun.split("_", 1)[1]
    is_matern = covfun.startswith("matern")
    x = np.asarray(coords, dtype=np.float64)
    if kind in ("isotropic", "sphere"):
        scaled = x / natural[0]
        nu = natural[1] if is_matern else None
    elif kind == "scaledim":
        nd = x.shape[-1]
        scaled = x / natural[:nd]
        nu = natural[nd] if is_matern else None
    elif kind == "spacetime":
        r = np.concatenate([np.full(x.shape[-1] - 1, natural[0]), [natural[1]]])
        scaled = x / r
        nu = natural[2] if is_matern else None
    else:
        raise ValueError(kind)
    diff = scaled[..., :, None, :] - scaled[..., None, :, :]
    d = np.sqrt(np.maximum((diff * diff).sum(-1), 0.0))
    if is_matern:
        safe = np.maximum(d, 1e-10)
        K = (
            2.0 ** (1 - nu)
            / scipy.special.gamma(nu)
            * safe**nu
            * scipy.special.kv(nu, safe)
        )
        return np.where(d <= 1e-10, 1.0, K)
    return np.exp(-d)


def np_vecchia_linv(coords, NN, covfun, natural):
    """Batched compressed factor build (BLAS path), rows [n, m+1]."""
    NN = np.asarray(NN)
    mask = NN >= 0
    k = NN.shape[1]
    safe = np.maximum(NN, 0)
    pts = np.asarray(coords, dtype=np.float64)[safe]
    K = np_correlation(covfun, pts, natural)
    valid = mask[:, :, None] & mask[:, None, :]
    K = np.where(valid, K, np.eye(k)[None])
    if k == 1:
        return np.ones((NN.shape[0], 1))
    Knn = K[:, 1:, 1:]
    kni = K[:, 1:, 0]
    L = np.linalg.cholesky(Knn)
    u = np.linalg.solve(L, kni[..., None])[..., 0]
    d = np.maximum(K[:, 0, 0] - (u * u).sum(-1),
                   1e-5 if covfun.startswith("matern") else 1e-12)
    b = np.linalg.solve(np.transpose(L, (0, 2, 1)), u[..., None])[..., 0]
    out = np.concatenate([1 / np.sqrt(d)[:, None], -b / np.sqrt(d)[:, None]], 1)
    return out * mask


def np_sparse_L(linv, NN):
    NN = np.asarray(NN)
    mask = NN >= 0
    n = NN.shape[0]
    rows = np.repeat(np.arange(n), mask.sum(1))
    return sparse.csr_matrix(
        (np.asarray(linv)[mask], (rows, NN[mask])), shape=(n, n)
    )


def np_mean_field_sweep(linv, NN, blocks, field, beta_0, log_scale,
                        log_noise_variance, rsum, obs_per_loc):
    """One zero-noise chromatic sweep in float64: the deterministic
    mean-field map of mcmc_nngp_update_Gaussian.R:254-275.

    ``blocks`` is the walk order, a sequence of site-index arrays (entries
    >= n are padding).  Each block's sites take, at once, the conditional
    mean beta_0 - (e^{-ls} sum_{j~s} Q_sj (w_j - beta_0) - e^{-lnv} rsum_s)
    / P_s with P_s = e^{-ls} Q_ss + e^{-lnv} obs_per_loc_s and Q = L'L."""
    n = NN.shape[0]
    L = np_sparse_L(np.asarray(linv, dtype=np.float64), NN)
    Q = (L.T @ L).tocsr()
    qdiag = Q.diagonal()
    Qoff = (Q - sparse.diags(qdiag)).tocsr()
    inv_scale = np.exp(-float(log_scale))
    inv_noise = np.exp(-float(log_noise_variance))
    P = inv_scale * qdiag + inv_noise * np.asarray(obs_per_loc, np.float64)
    rsum = np.asarray(rsum, dtype=np.float64)
    w = np.array(field, dtype=np.float64)
    for blk in blocks:
        s = np.asarray(blk)
        s = s[s < n]
        prior = Qoff[s] @ (w - beta_0)
        w[s] = beta_0 - (inv_scale * prior - inv_noise * rsum[s]) / P[s]
    return w


def np_solve_L(linv, NN, v, levels=None):
    """x = L^-1 v by the same level-scheduled substitution as the device
    kernel (ops/trisolve.py) — vectorized NumPy per DAG level.  (SuperLU on
    the triangular factor is ~1000x slower: full symbolic analysis.)"""
    from nngp_tpu.preprocess.coloring import dag_levels

    NN = np.asarray(NN)
    linv = np.asarray(linv, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    n = NN.shape[0]
    if levels is None:
        levels = dag_levels(NN)
    mask = (NN[:, 1:] >= 0)
    parents = np.maximum(NN[:, 1:], 0)
    x = np.zeros(n)
    order = np.argsort(levels, kind="stable")
    bounds = np.searchsorted(levels[order], np.arange(levels.max() + 1))
    bounds = np.append(bounds, n)
    for l in range(levels.max() + 1):
        rows = order[bounds[l] : bounds[l + 1]]
        acc = (linv[rows, 1:] * mask[rows] * x[parents[rows]]).sum(axis=1)
        x[rows] = (v[rows] - acc) / linv[rows, 0]
    return x
