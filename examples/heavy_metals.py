"""Heavy-metals workload: the reference's real-data application.

Mirrors the reference's Heavy_metals/run_script.R — US lead measurements at
64,274 lon/lat sites, 14 covariates, exponential_sphere kernel, m=5,
3 chains, field_thinning 0.5, up to 20 cycles x 200 iterations with
Gelman-Rubin-Brooks stopping at (1.00, 1.00) — and the headline outputs of
Results_analysis.R (estimates with ranges scaled to km by the Earth
radius, Results_analysis.R:139).

Run:  PYTHONPATH=. python examples/heavy_metals.py [--cycles N] [--quick]
"""

import argparse
import time

import numpy as np

import nngp_tpu
from nngp_tpu.utils.compile_cache import enable_compilation_cache

enable_compilation_cache()
from nngp_tpu.utils.datasets import load_heavy_metals

EARTH_RADIUS_KM = 6371.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=20)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--save", default=None)
    ap.add_argument("--schedule", default="classed",
                    help="chromatic schedule: classed | flat")
    ap.add_argument("--log", default=None, help="jsonl cycle log path")
    args = ap.parse_args()

    locs, y, X = load_heavy_metals()
    if args.quick:
        k = 8000
        locs, y = locs[:k], y[:k]
        X = {n: v[:k] for n, v in X.items()}
        args.cycles = min(args.cycles, 3)

    t0 = time.time()
    mc = nngp_tpu.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=3, seed=1,
    )
    mc = nngp_tpu.run(
        mc,
        n_cycles=args.cycles,
        n_iterations_update=args.iters,
        field_thinning=0.5,
        Gelman_Rubin_Brooks_stop=(1.00, 1.00),
        save_name=args.save,
        verbose=True,
        chromatic_schedule=args.schedule,
        log_jsonl=args.log,
    )
    print(f"total fit time: {time.time() - t0:.1f}s "
          f"({mc.iterations} iterations/chain)")

    est = nngp_tpu.estimate(mc)
    gp = est["covariance_params"]["GpGp_covparams"]
    print("covariance parameters (GpGp parametrization; range in km):")
    for nm, row in zip(gp["names"], gp["table"]):
        scale = EARTH_RADIUS_KM if nm == "range" else 1.0
        unit = " km" if nm == "range" else ""
        print(f"  {nm:16s} mean={row[0]*scale:10.3f}{unit}  "
              f"CI=[{row[1]*scale:10.3f}, {row[3]*scale:10.3f}]")
    fe = est["fixed_effects"]
    print("significant fixed effects (zero outside 95% CI):")
    for nm, row, sig in zip(fe["names"], fe["table"], fe["zero_out_of_ci"]):
        if sig:
            print(f"  {nm:16s} mean={row[0]:9.4f}  "
                  f"CI=[{row[1]:9.4f}, {row[3]:9.4f}]")


if __name__ == "__main__":
    main()
