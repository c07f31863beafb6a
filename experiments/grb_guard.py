"""Validate diagnostics/grb.py's spectral-floor guard against the
reference's exact MPSRF semantics on identical inputs (VERDICT r3 item 3).

The reference computes (Scripts/mcmc_nngp_diagnose.R:18)

    MPSRF = (n-1)/n + (m+1)/m * svd(solve(W, tol=rcond(W)) %*% B)$d[1]

R's ``solve(a, b, tol=...)`` uses ``tol`` only to decide when to *error*
("system is computationally singular"); passing ``tol = rcond(W)`` sets the
error threshold to W's own estimated reciprocal condition number, i.e. it
disables the singularity error and performs a PLAIN LAPACK inverse.  The
reference therefore has no regularization at all: a near-singular W blows
the MPSRF up by 1/eps along its near-null directions.

Our build (nngp_tpu/diagnostics/grb.py) floors W's eigenvalues at 1e-8 of
its largest before inverting.  This script quantifies when the two agree
and when (and how) they diverge:

  A. well-conditioned records  -> identical to ~1e-10 (floor inactive)
  B. near-collinear parameter pair (kappa(W) ~ 1e10) -> reference MPSRF
     explodes with the collinearity epsilon; floored MPSRF stays finite
  C. 3 chains, p params, rank(B) <= 2: the between matrix is rank-deficient
     by construction — MPSRF mixes the top-B direction with W's
     conditioning, which is why it can plateau >> 1 while every univariate
     PSRF is ~1 (the reference's own stop rule, mcmc_nngp_run.R:42-46,
     accepts `all univariate < stop[2]` for exactly this reason)

Also provides `principal_direction(chains)` used by the HM plateau
analysis: the eigenvector of solve(W) @ B carrying lambda_max, labeled by
parameter name.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nngp_tpu.diagnostics.grb import Gelman_Rubin_Brooks


def mpsrf_reference(chains):
    """Exact R semantics: plain solve (no regularization), svd top value.

    chains: list of [T, p] arrays (post burn-in slices, as diagnose.R:4-9).
    """
    m = len(chains)
    n = chains[0].shape[0]
    W = sum(np.cov(c.T) for c in chains) / m
    means = np.stack([c.mean(axis=0) for c in chains], axis=1)
    B = np.cov(means)
    lam = np.linalg.svd(np.linalg.solve(W, B), compute_uv=False)[0]
    return (n - 1) / n + (m + 1) / m * lam, W, B


def principal_direction(chains, names=None):
    """Eigen-direction of W^-1 B carrying lambda_max (unsymmetric problem:
    use eig of solve(W) @ B), with per-parameter loadings standardized by
    within-chain sd so loadings are comparable across scales."""
    m = len(chains)
    W = sum(np.cov(c.T) for c in chains) / m
    means = np.stack([c.mean(axis=0) for c in chains], axis=1)
    B = np.cov(means)
    A = np.linalg.solve(W, B)
    ew, ev = np.linalg.eig(A)
    k = int(np.argmax(ew.real))
    v = ev[:, k].real
    # loading of each parameter in the slow direction, scaled to the
    # parameter's own within-chain sd (so a loading is "how much of this
    # parameter's natural scale participates")
    sd = np.sqrt(np.diag(W))
    load = v * sd
    load = load / np.max(np.abs(load))
    order = np.argsort(-np.abs(load))
    out = {
        "lambda_max": float(ew.real[k]),
        "loadings": [
            {
                "param": names[i] if names is not None else f"p{i}",
                "loading": round(float(load[i]), 4),
            }
            for i in order
        ],
        "cond_W": float(np.linalg.cond(W)),
    }
    return out


def _records_from_chains(chains):
    """Wrap [T, p] chain matrices as nngp records (all p as 'beta')."""
    recs = []
    for c in chains:
        recs.append({
            "beta_0": c[:, 0],
            "beta": c[:, 1:],
            "log_scale": np.zeros(0),
            "log_noise_variance": np.zeros(0),
            "shape": np.zeros((0, 1)),
        })
    # grb._stack_nonfield_samples skips empty blocks? it doesn't — give it
    # a clean direct path instead: emulate with only beta_0+beta columns.
    for r in recs:
        del r["log_scale"], r["log_noise_variance"], r["shape"]
    return recs


def simulate(m=3, T=400, p=8, eps=None, seed=0, mean_shift=0.0):
    """AR(1) chains; optional near-duplicate parameter pair with gap eps;
    optional per-chain mean shift along a random direction."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=p)
    dirs /= np.linalg.norm(dirs)
    chains = []
    for ci in range(m):
        z = np.zeros((T, p))
        x = rng.normal(size=p)
        for t in range(T):
            x = 0.6 * x + rng.normal(size=p)
            z[t] = x
        if eps is not None:
            # column 1 := column 0 + eps * noise  -> W nearly singular
            z[:, 1] = z[:, 0] + eps * rng.normal(size=T)
        z += mean_shift * dirs * (ci - (m - 1) / 2)
        chains.append(z)
    return chains


def main():
    out = {}

    # A. well-conditioned: floor inactive, exact agreement
    chains = simulate(eps=None, mean_shift=0.15)
    ref, W, B = mpsrf_reference(chains)
    ours = Gelman_Rubin_Brooks(_records_from_chains(chains), burn_in=0.0)
    out["A_well_conditioned"] = {
        "mpsrf_reference_semantics": float(ref),
        "mpsrf_ours": float(ours["R_hat"][0]),
        "abs_diff": float(abs(ref - ours["R_hat"][0])),
        "cond_W": float(np.linalg.cond(W)),
    }

    # B. near-collinear pair: reference explodes ~1/eps^2, ours floors
    rows = []
    for eps in (1e-2, 1e-4, 1e-6):
        chains = simulate(eps=eps, mean_shift=0.15)
        ref, W, _ = mpsrf_reference(chains)
        ours = Gelman_Rubin_Brooks(_records_from_chains(chains), burn_in=0.0)
        rows.append({
            "eps": eps,
            "cond_W": float(np.linalg.cond(W)),
            "mpsrf_reference_semantics": float(ref),
            "mpsrf_ours": float(ours["R_hat"][0]),
            "max_univariate": float(np.max(ours["R_hat"][1:])),
        })
    out["B_near_collinear"] = rows

    # C. stationary chains (no shift), p > m-1: B is rank m-1=2; both
    # implementations agree (W fine) but MPSRF sits above 1 purely from
    # the noisy rank-2 between estimate
    chains = simulate(eps=None, mean_shift=0.0, T=400)
    ref, W, B = mpsrf_reference(chains)
    ours = Gelman_Rubin_Brooks(_records_from_chains(chains), burn_in=0.0)
    out["C_stationary_rank_deficient_B"] = {
        "rank_B": int(np.linalg.matrix_rank(B)),
        "mpsrf_reference_semantics": float(ref),
        "mpsrf_ours": float(ours["R_hat"][0]),
        "max_univariate": float(np.max(ours["R_hat"][1:])),
    }

    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
