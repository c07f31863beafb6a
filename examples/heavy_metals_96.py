"""Heavy-metals 20x200 protocol at 96 chains on one device.

Same per-chain budget as the reference protocol (Heavy_metals/
run_script.R:15: 20 cycles x 200 iterations), but 96 vmapped chains
instead of 3 forked ones — more chains per device amortize the shared
gathers (docs/scaling.md) and, critically, this is the configuration where the
multivariate-PSRF criterion is actually estimable: with 3 chains the
between matrix has rank 2 and lambda_max maximizes over 18 dimensions,
so a direction with IACT ~100 fails MPSRF < 1.1 ~40% of the time even
for a perfect sampler (experiments/mpsrf_estimator_sim.json); 96 chains
remove that estimator noise without touching the per-chain budget.

Field records are column-subsampled (64 monitored sites) to keep the
per-cycle device->host pull small at 96 chains; the GRB/MPSRF criterion
uses the scalar records only.

Run:  PYTHONPATH=. python examples/heavy_metals_96.py
"""

import argparse
import os
import time

import numpy as np

import nngp_tpu
from nngp_tpu.utils.compile_cache import enable_compilation_cache

enable_compilation_cache()

from nngp_tpu.utils.datasets import load_heavy_metals


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=20)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--chains", type=int, default=96)
    ap.add_argument("--schedule", default="classed",
                    help="chromatic schedule: classed | flat")
    ap.add_argument("--covparams-steps", type=int, default=1)
    ap.add_argument("--log", default="experiments/hm_convergence_r5_96.jsonl")
    args = ap.parse_args()

    locs, y, X = load_heavy_metals()
    t0 = time.time()
    mc = nngp_tpu.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=args.chains, seed=1,
    )
    rng = np.random.default_rng(0)
    cols = np.sort(rng.choice(mc.graph.n, size=64, replace=False))
    knobs = dict(
        n_iterations_update=args.iters,
        field_thinning=0.05,
        Gelman_Rubin_Brooks_stop=(1.00, 1.00),
        verbose=True,
        chromatic_schedule=args.schedule,
        log_jsonl=args.log,
        field_record_columns=cols,
    )
    if args.covparams_steps > 1:
        # two-phase: K=1 through the adaptation window (extra ASIS moves
        # per iteration during step-size adaptation destabilize burn-in —
        # a from-the-start K=3 run diverged, experiments/hm_96_K3_run.log),
        # then K ASIS pairs per iteration for the sampling half.  The
        # per-chain iteration budget is unchanged and the burn_in=0.5
        # MPSRF window covers exactly the K-phase.
        half = int(os.environ.get("HM96_PHASE1_CYCLES", str(args.cycles // 2)))
        mc = nngp_tpu.run(mc, n_cycles=half, **knobs)
        mc = nngp_tpu.run(mc, n_cycles=args.cycles - half,
                          covparams_steps=args.covparams_steps, **knobs)
    else:
        mc = nngp_tpu.run(mc, n_cycles=args.cycles, **knobs)
    print(f"total fit time: {time.time() - t0:.1f}s "
          f"({mc.iterations} iterations/chain, {args.chains} chains)")
    grb = mc.diagnostics["Gelman_Rubin_Brooks"][-1]
    print("final R-hat:", dict(zip(grb["names"], np.round(grb["R_hat"], 4))))


if __name__ == "__main__":
    main()
