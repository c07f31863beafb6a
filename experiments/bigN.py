"""Single-device throughput at halo-scale n: the per-iteration cost at
n >= 500k that the halo mode's 'sites' axis would divide, plus the
halo-plan table sizes at that n.

Synthetic uniform-square workload, middleout ordering (exact maxmin is
O(n^2) host time at 500k; ordering choice doesn't change per-iteration
device cost).

Run:  python experiments/bigN.py --n 500000 --schedule classed
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--chains", type=int, default=3)
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--schedule", default="classed")
    ap.add_argument("--halo-plan", action="store_true",
                    help="also build (host-side) the D=8 halo plan and "
                         "report its table sizes")
    ap.add_argument("--out", default="experiments/bigN.jsonl")
    args = ap.parse_args()

    import nngp_tpu

    rng = np.random.default_rng(0)
    n = args.n
    locs = rng.uniform(0, 1000.0, size=(n, 2))
    w = np.sin(locs[:, 0] / 40.0) * np.cos(locs[:, 1] / 55.0)
    y = 1.0 + w + rng.normal(size=n) * 0.6

    t0 = time.time()
    mc = nngp_tpu.initialize(
        locs, y, m=5, reordering="middleout",
        stationary_covfun="exponential_isotropic",
        n_chains=args.chains, seed=1,
    )
    setup_s = time.time() - t0
    print(f"setup {setup_s:.1f}s  n={mc.graph.n}", flush=True)

    knobs = dict(n_iterations_update=args.iters, verbose=False,
                 field_thinning=2.0 / args.iters,
                 Gelman_Rubin_Brooks_stop=(0.0, 0.0),
                 chromatic_schedule=args.schedule,
                 max_device_iters=args.iters)
    t0 = time.time()
    mc = nngp_tpu.run(mc, n_cycles=1, **knobs)      # compile + warm
    compile_s = time.time() - t0
    t0 = time.time()
    mc = nngp_tpu.run(mc, n_cycles=2, **knobs)      # timed
    wall = time.time() - t0
    ms_per_iter = wall / (2 * args.iters) * 1000
    print(f"compile+first {compile_s:.1f}s; timed {wall:.1f}s "
          f"=> {ms_per_iter:.1f} ms/iter at {args.chains} chains", flush=True)

    entry = {
        "backend": jax.default_backend(),
        "n": int(mc.graph.n),
        "chains": args.chains,
        "schedule": args.schedule,
        "setup_s": round(setup_s, 1),
        "compile_s": round(compile_s, 1),
        "ms_per_iter": round(ms_per_iter, 1),
        "it_per_s": round(1000.0 / ms_per_iter, 3),
    }

    if args.halo_plan:
        from nngp_tpu.parallel.halo import build_halo_plan

        t0 = time.time()
        plan = build_halo_plan(mc.graph, 8)
        need = np.asarray(plan.need_rows)
        halo_frac = float((need < mc.graph.n).sum() / mc.graph.n) - 1.0
        entry["halo_plan"] = {
            "D": 8,
            "build_s": round(time.time() - t0, 1),
            "need_rows_per_device": int((need < mc.graph.n).sum(1).max()),
            "halo_overlap_fraction": round(halo_frac, 4),
        }
        print(f"halo plan D=8: {entry['halo_plan']}", flush=True)

    with open(args.out, "a") as f:
        f.write(json.dumps(entry) + "\n")
    print(f"appended to {args.out}")


if __name__ == "__main__":
    main()
