"""How large is the multivariate-PSRF *estimator* at a given true mixing
speed?  (VERDICT r4 item 1 context.)

The HM protocol's stop rule leads with MPSRF < 1.1 (mcmc_nngp_run.R:42-46)
computed from m chains x n kept samples in p=18 dimensions
(mcmc_nngp_diagnose.R:12-23).  With m=3 the between matrix B has rank 2
and lambda_max(W^-1 B) maximizes over 18 dimensions — even a perfectly
converged sampler shows MPSRF >> 1 when any direction's IACT tau is large
relative to n/(estimator inflation).

Simulation: p independent stationary AR(1) series per chain with IACT
tau_j (one slow direction at tau_slow, rest fast), exact reference MPSRF
formula, repeated over many replicates.  Reports the MPSRF sampling
distribution at the HM budget (n=2000 kept after burn-in) for m = 3 and
m = 96 chains.

This is the quantitative basis for running the reference's own 20x200
per-chain protocol at 96 chains on one device: the per-chain budget is
unchanged; only the criterion's estimator noise shrinks.
"""

import json
import sys

import numpy as np


def ar1(rng, n, tau):
    """Stationary AR(1) with integrated autocorrelation time ~tau."""
    # tau = (1+phi)/(1-phi)  =>  phi = (tau-1)/(tau+1)
    phi = (tau - 1.0) / (tau + 1.0)
    x = np.empty(n)
    x[0] = rng.normal() / np.sqrt(1 - phi**2)
    eps = rng.normal(size=n)
    for t in range(1, n):
        x[t] = phi * x[t - 1] + eps[t]
    return x * np.sqrt(1 - phi**2)   # unit marginal variance


def mpsrf(chains):
    """Reference formula (mcmc_nngp_diagnose.R:12-23)."""
    m, n, p = chains.shape
    W = np.mean([np.cov(c.T) for c in chains], axis=0)
    mu = chains.mean(axis=1)
    B_over_n = np.cov(mu.T)
    lam = np.linalg.eigvals(np.linalg.solve(W, B_over_n)).real.max()
    return (n - 1) / n + (m + 1) / m * lam


def main():
    rng = np.random.default_rng(0)
    p = 18
    n = 2000                      # kept samples at the 20x200 HM budget
    tau_fast = 5.0
    out = {"p": p, "n_kept": n, "tau_fast": tau_fast, "results": []}
    for tau_slow in (30.0, 100.0, 150.0):
        for m, reps in ((3, 200), (96, 30)):
            vals = []
            for _ in range(reps):
                ch = np.empty((m, n, p))
                for c in range(m):
                    for j in range(p):
                        tau = tau_slow if j == 0 else tau_fast
                        ch[c, :, j] = ar1(rng, n, tau)
                vals.append(mpsrf(ch))
            vals = np.array(vals)
            row = {
                "tau_slow": tau_slow, "chains": m, "reps": reps,
                "mpsrf_median": round(float(np.median(vals)), 3),
                "mpsrf_q90": round(float(np.quantile(vals, 0.9)), 3),
                "frac_below_1.1": round(float((vals < 1.1).mean()), 3),
            }
            out["results"].append(row)
            print(row, flush=True)
    with open("experiments/mpsrf_estimator_sim.json", "w") as f:
        json.dump(out, f, indent=1)
    print("wrote experiments/mpsrf_estimator_sim.json")


if __name__ == "__main__":
    main()
