"""Converged Matérn fit on the current backend (the fit that follows
experiments/matern_probe.py).

Simulates a 2-D Matérn GP with known truth (nu=0.8, range 0.12, scale
2.0, noise 0.4), fits with matern_isotropic on the engine's full path
(complementary-series correlation + d-floor factor build, AM proposals),
runs cycles until every univariate R-hat <= 1.05, and writes the
trajectory + posterior-vs-truth table.

Run:  python examples/matern_fit.py \
          [--n 2000] [--log experiments/matern_fit.jsonl]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from nngp_tpu.utils.compile_cache import enable_compilation_cache

enable_compilation_cache()

import numpy as np
from scipy.special import gamma as sp_gamma, kv as sp_kv

import nngp_tpu


def simulate(rng, n, nu, rho, scale, noise_var, beta_0):
    locs = rng.uniform(0, 1, size=(n, 2))
    d = np.sqrt(((locs[:, None] - locs[None]) ** 2).sum(-1)) / rho
    safe = np.maximum(d, 1e-10)
    C = (2.0 ** (1 - nu) / sp_gamma(nu)) * safe**nu * sp_kv(nu, safe)
    C[d <= 1e-10] = 1.0
    K = scale * C
    w = np.linalg.cholesky(K + 1e-7 * np.eye(n)) @ rng.normal(size=n)
    y = beta_0 + w + rng.normal(size=n) * np.sqrt(noise_var)
    return locs, y


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--cycles", type=int, default=28)
    ap.add_argument("--iters", type=int, default=250)
    ap.add_argument("--chains", type=int, default=6)
    ap.add_argument("--covparams-steps", type=int, default=3)
    ap.add_argument("--noise", type=float, default=0.4,
                    help="noise variance of the simulated truth; smoothness "
                         "is identified by fine-scale increments, so a "
                         "smaller noise makes the toy sharper on nu")
    ap.add_argument("--log", default="experiments/matern_fit.jsonl")
    args = ap.parse_args()

    truth = dict(nu=0.8, rho=0.12, scale=2.0, noise_var=args.noise,
                 beta_0=1.0)
    rng = np.random.default_rng(11)
    locs, y = simulate(rng, args.n, truth["nu"], truth["rho"],
                       truth["scale"], truth["noise_var"], truth["beta_0"])
    t0 = time.time()
    mc = nngp_tpu.initialize(
        locs, y, m=8, n_chains=args.chains,
        stationary_covfun="matern_isotropic", seed=4,
    )
    knobs = dict(n_iterations_update=args.iters,
                 Gelman_Rubin_Brooks_stop=(1.05, 1.03),
                 log_jsonl=args.log, verbose=True)
    # two-phase: reference-semantics K=1 through the adaptation window,
    # then covparams_steps ASIS pairs per iteration — the smoothness ridge
    # (qlogis_smoothness ~ log_range ~ log_scale) is the slow direction at
    # toy n, exactly what the K multiplier accelerates
    phase1 = max(1, (2000 + args.iters - 1) // args.iters)
    mc = nngp_tpu.run(mc, n_cycles=min(phase1, args.cycles), **knobs)
    if args.cycles > phase1:
        mc = nngp_tpu.run(mc, n_cycles=args.cycles - phase1,
                          covparams_steps=args.covparams_steps, **knobs)
    wall = time.time() - t0
    grb = mc.diagnostics["Gelman_Rubin_Brooks"][-1]
    max_uni = float(np.max(grb["R_hat"][1:]))
    est = nngp_tpu.estimate(mc)
    gp = est["covariance_params"]["GpGp_covparams"]
    rows = dict(zip(gp["names"], gp["table"]))
    print(f"\nfit: {mc.iterations} iters/chain, {wall:.1f}s, "
          f"max univariate R-hat {max_uni:.3f}")
    print(f"truth: scale {truth['scale']}, range {truth['rho']}, "
          f"smoothness {truth['nu']}, noise {truth['noise_var']}")
    for nm, r in rows.items():
        print(f"  {nm:16s} mean={r[0]:8.4f}  CI=[{r[1]:8.4f}, {r[3]:8.4f}]")
    summary = {
        "backend": jax.default_backend(), "n": args.n,
        "iterations": mc.iterations, "wall_s": round(wall, 1),
        "max_univariate_rhat": round(max_uni, 4),
        "truth": truth,
        "posterior": {nm: {"mean": round(float(r[0]), 4),
                           "ci": [round(float(r[1]), 4),
                                  round(float(r[3]), 4)]}
                      for nm, r in rows.items()},
    }
    with open(args.log, "a") as f:
        f.write(json.dumps({"summary": summary}) + "\n")
    assert max_uni <= 1.05, f"did not converge: {max_uni}"
    # identifiable-quantity sanity: noise CI covers truth
    lo, hi = rows["noise_variance"][1], rows["noise_variance"][3]
    assert lo * 0.8 <= truth["noise_var"] <= hi * 1.2, rows["noise_variance"]
    print("converged (all univariate R-hat <= 1.05); noise CI covers truth")


if __name__ == "__main__":
    main()
