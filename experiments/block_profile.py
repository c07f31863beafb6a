#!/usr/bin/env python
"""Per-block ms breakdown of one Gibbs iteration at Heavy-metals scale:
ancillary (factor+level-solve+co-transform) / sufficient (factor+loglik) /
beta / 10x chromatic sweeps / noise, plus the primitive kernels
(vecchia_linv, level_solve, linv_mult) and the whole iteration.

Each block is timed as `reps` chained repetitions inside ONE jitted
fori_loop, so per-call dispatch does not enter ms-scale blocks.  One
problem is built for the largest chain count; smaller counts take the
first chains of it.  Appends one JSON line per (chains, schedule) to --out.

Run:  python experiments/block_profile.py --chains 3,96 --schedule classed,flat
      python experiments/block_profile.py --chains 3 --full-only
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

import jax.numpy as jnp
import numpy as np
from jax import lax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", default="3",
                    help="comma-separated chain counts")
    ap.add_argument("--schedule", default="classed",
                    help="comma-separated sweep schedules: classed | flat")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--full-only", action="store_true",
                    help="time only the whole iteration")
    ap.add_argument("--gap", action="store_true",
                    help="also time cumulative prefixes of the production "
                         "iteration body (full-vs-blocks gap attribution)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="experiments/block_profile.jsonl")
    args = ap.parse_args()

    import nngp_tpu
    from nngp_tpu.api import _device_problem
    from nngp_tpu.utils.datasets import load_heavy_metals

    locs, y, X = load_heavy_metals()
    if args.quick:
        k = 8000
        locs, y = locs[:k], y[:k]
        X = {n: v[:k] for n, v in X.items()}

    chain_counts = [int(c) for c in args.chains.split(",")]
    mc = nngp_tpu.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=max(chain_counts), seed=1,
    )
    graph, data = _device_problem(mc)
    for C in chain_counts:
        states = jax.device_put(jax.tree.map(lambda x: x[:C], mc.states))
        for schedule in args.schedule.split(","):
            profile(args, mc, graph, data, states, C, schedule)


def profile(args, mc, graph, data, states, C, schedule):
    from nngp_tpu.models.gaussian import (
        UpdateConfig,
        _ancillary_step,
        _beta_step,
        _chromatic_sweeps,
        _mu_obs,
        _natural_shape,
        _noise_steps,
        _sufficient_step,
        gibbs_iteration,
    )
    from nngp_tpu.ops.trisolve import level_solve
    from nngp_tpu.ops.vecchia import linv_mult, vecchia_linv

    names = mc.space_time_model["covfun"]["shape_params"]
    cfg = UpdateConfig(
        n_iterations=1, shape_names=tuple(names),
        locs_cols=tuple(int(c) for c in mc.design.locs_cols),
        chromatic_schedule=schedule,
    )
    key = jax.random.key(0)
    reps = args.reps

    def timeit(name, jitted, *call_args):
        t0 = time.time()
        out = jitted(*call_args)                    # compile
        jax.block_until_ready(out)
        t_compile = time.time() - t0
        t0 = time.time()
        out = jitted(*call_args)
        jax.block_until_ready(out)
        total = time.time() - t0
        ms = total / reps * 1000.0
        print(f"{name:28s} {ms:9.3f} ms  ({total:.2f}s / {reps}; first call "
              f"{t_compile:.1f}s)", flush=True)
        return ms

    print(f"--- {C} chains, schedule {schedule}", flush=True)
    results = {}
    linv_b = jax.jit(jax.vmap(
        lambda sh: vecchia_linv(graph, _natural_shape(cfg, sh))
    ))(states.shape)
    jax.block_until_ready(linv_b)

    # --- whole iteration (the scan body used in production) ---
    @jax.jit
    def whole(states, linv_b):
        def body(i, carry):
            st, lv = carry
            k = jax.random.fold_in(key, i)

            def one(s, l, kk):
                (c, rec) = gibbs_iteration(
                    graph, data, cfg,
                    (s, l, jnp.zeros((), s.field.dtype),
                     jnp.zeros((), s.field.dtype)),
                    (kk, jnp.int32(1), jnp.int32(10 ** 9)),
                )
                return c[0], c[1]
            return jax.vmap(one)(st, lv, jax.random.split(k, C))
        return lax.fori_loop(0, reps, body, (states, linv_b))

    results["full_iteration"] = timeit("full gibbs iteration", whole,
                                       states, linv_b)

    if args.full_only:
        _append(args.out, mc, C, schedule, reps, results)
        return

    # --- primitive kernels (vmapped over chains) ---
    @jax.jit
    def k_factor(states):
        def body(i, acc):
            nat = jax.vmap(lambda sh: _natural_shape(cfg, sh + i * 1e-7))(
                states.shape)
            lv = jax.vmap(lambda nt: vecchia_linv(graph, nt))(nat)
            # consume every row, or XLA keeps only the one element used
            return acc + jnp.sum(lv, axis=(1, 2))
        return lax.fori_loop(0, reps, body, jnp.zeros(C))

    results["vecchia_linv"] = timeit("vecchia_linv (factor build)", k_factor,
                                     states)

    @jax.jit
    def k_solve(states, linv_b):
        def body(i, v):
            return jax.vmap(lambda lv, x: level_solve(lv, x, graph))(linv_b, v)
        return lax.fori_loop(0, reps, body, states.field)

    results["level_solve"] = timeit("level_solve", k_solve, states, linv_b)

    @jax.jit
    def k_mult(states, linv_b):
        def body(i, v):
            return jax.vmap(lambda lv, x: linv_mult(lv, x, graph))(linv_b, v)
        return lax.fori_loop(0, reps, body, states.field)

    results["linv_mult"] = timeit("linv_mult", k_mult, states, linv_b)

    # --- sampler blocks ---
    def block_loop(step):
        def run(states, linv_b):
            def body(i, carry):
                st, lv = carry
                k = jax.random.fold_in(key, i)
                return step(st, lv, k)
            return lax.fori_loop(0, reps, body, (states, linv_b))
        return jax.jit(run)

    def anc(st, lv, k):
        def one(s, l, kk):
            mu = _mu_obs(data, s, graph)
            s2, l2, _ = _ancillary_step(graph, data, cfg, s, l, mu, kk)
            return s2, l2
        return jax.vmap(one)(st, lv, jax.random.split(k, C))

    results["ancillary_block"] = timeit("ancillary MH block",
                                        block_loop(anc), states, linv_b)

    def suf(st, lv, k):
        def one(s, l, kk):
            s2, l2, _ = _sufficient_step(graph, data, cfg, s, l, kk)
            return s2, l2
        return jax.vmap(one)(st, lv, jax.random.split(k, C))

    results["sufficient_block"] = timeit("sufficient MH block",
                                         block_loop(suf), states, linv_b)

    def beta(st, lv, k):
        def one(s, l, kk):
            return _beta_step(graph, data, cfg, s, l, kk), l
        return jax.vmap(one)(st, lv, jax.random.split(k, C))

    results["beta_block"] = timeit("beta block (interweaved)",
                                   block_loop(beta), states, linv_b)

    def sweeps(st, lv, k):
        def one(s, l, kk):
            mu = _mu_obs(data, s, graph)
            return _chromatic_sweeps(graph, data, cfg, s, l, mu, kk), l
        return jax.vmap(one)(st, lv, jax.random.split(k, C))

    results["chromatic_sweeps_x10"] = timeit(
        f"10x chromatic sweeps ({schedule})", block_loop(sweeps),
        states, linv_b)

    def noise(st, lv, k):
        def one(s, l, kk):
            mu = _mu_obs(data, s, graph)
            return _noise_steps(graph, data, cfg, s, mu, kk), l
        return jax.vmap(one)(st, lv, jax.random.split(k, C))

    results["noise_block_x10"] = timeit("10x noise MH", block_loop(noise),
                                        states, linv_b)

    # --- cumulative-prefix timings of the REAL iteration body (chases the
    # full-vs-sum-of-blocks gap: isolated blocks can fuse/schedule
    # differently than the production composition) ---
    if args.gap:
        from nngp_tpu.models.gaussian import _pre_chromatic

        def prefix(upto):
            @jax.jit
            def run(states, linv_b):
                def body(i, carry):
                    st, lv = carry
                    k = jax.random.fold_in(key, i)

                    def one(s, l, kk):
                        carry1, mu, k_sw, k_nz = _pre_chromatic(
                            graph, data, cfg,
                            (s, l, jnp.zeros((), s.field.dtype),
                             jnp.zeros((), s.field.dtype)),
                            (kk, jnp.int32(1), jnp.int32(10 ** 9)),
                        )
                        s2, l2 = carry1[0], carry1[1]
                        if upto >= 1:
                            s2 = _chromatic_sweeps(
                                graph, data, cfg, s2, l2, mu, k_sw)
                        if upto >= 2:
                            s2 = _noise_steps(graph, data, cfg, s2, mu, k_nz)
                        return s2, l2
                    return jax.vmap(one)(st, lv, jax.random.split(k, C))
                return lax.fori_loop(0, reps, body, (states, linv_b))
            return run

        results["prefix_pre"] = timeit("prefix: pre-chromatic only",
                                       prefix(0), states, linv_b)
        results["prefix_pre_sweeps"] = timeit("prefix: pre + sweeps",
                                              prefix(1), states, linv_b)
        results["prefix_pre_sweeps_noise"] = timeit(
            "prefix: pre + sweeps + noise", prefix(2), states, linv_b)
    block_sum = (results["ancillary_block"] + results["sufficient_block"]
                 + results["beta_block"] + results["chromatic_sweeps_x10"]
                 + results["noise_block_x10"])
    print(f"{'sum of blocks':28s} {block_sum:9.3f} ms")
    _append(args.out, mc, C, schedule, reps, results,
            block_sum_ms=round(block_sum, 3))


def _append(path, mc, C, schedule, reps, results, **extra):
    dev = jax.devices()[0]
    entry = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "n": int(mc.graph.n),
        "chains": C,
        "schedule": schedule,
        "reps": reps,
        "ms": {k: round(v, 3) for k, v in results.items()},
        **extra,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(entry) + "\n")
    print(f"appended to {path}", flush=True)

if __name__ == "__main__":
    main()
