#!/usr/bin/env python
"""Multi-process chain-throughput scaling efficiency (CPU harness).

Measures the same quantity the north star asks for at 2+ hosts (≥80 %
chain-throughput scaling efficiency), on the only multi-"host" fabric this
box offers: 2 OS processes × 1 CPU device joined via jax.distributed/gloo
(the code path a real 2-host run takes), vs a single process doing all
the work.  Each process runs its chain shard through the shard_map'd cycle;
no cross-process traffic during the cycle (exactly like production — only
the GRB moments cross hosts, once per cycle).

Writes one JSON line: {"single_s", "two_proc_s", "efficiency"}.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys, time
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
sys.path.insert(0, sys.argv[4])
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
import numpy as np
if nproc > 1:
    from nngp_tpu.parallel.distributed import initialize_distributed
    initialize_distributed(f"localhost:{port}", nproc, pid)

import nngp_tpu
import jax.numpy as jnp
from nngp_tpu.models.gaussian import UpdateConfig
from nngp_tpu.parallel.chains import chains_mesh, make_sharded_cycle_fn, shard_states

N, CHAINS, ITERS = 4000, 8, 40
rng = np.random.default_rng(0)
locs = rng.uniform(size=(N, 2)) * 10
y = np.sin(locs[:, 0]) + rng.normal(size=N) * 0.5
mc = nngp_tpu.initialize(locs, y, m=5, n_chains=CHAINS, seed=2,
                         stationary_covfun="exponential_isotropic")
cfg = UpdateConfig(n_iterations=ITERS, shape_names=("log_range",), locs_cols=())
mesh = chains_mesh(jax.devices())
graph_d, data_d = jax.device_put((mc.graph, mc.data))
fn = make_sharded_cycle_fn(graph_d, data_d, cfg, mesh)
states = shard_states(mc.states, mesh)
base = jax.random.key(mc.seed)
keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(CHAINS))
s2, _ = fn(states, keys, jnp.asarray(0, jnp.int32))   # compile + warm
np.asarray(jax.tree.leaves(s2)[0].addressable_shards[0].data).sum()
t0 = time.time()
s3, _ = fn(s2, keys, jnp.asarray(ITERS, jnp.int32))
np.asarray(jax.tree.leaves(s3)[0].addressable_shards[0].data).sum()
dt = time.time() - t0
print(f"RESULT {dt:.4f}", flush=True)
"""


def run(nproc: int) -> float:
    port = 24411
    env = {
        "PATH": os.environ.get("PATH", ""),
        "HOME": os.environ.get("HOME", "/root"),
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
        "PYTHONUNBUFFERED": "1",
    }
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(WORKER)
        path = f.name
    procs = [
        subprocess.Popen(
            [sys.executable, path, str(pid), str(nproc), str(port), REPO],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(nproc)
    ]
    times = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        if p.returncode != 0:
            raise RuntimeError(out[-3000:])
        for line in out.splitlines():
            if line.startswith("RESULT"):
                times.append(float(line.split()[1]))
    return max(times)


def main():
    # single process, one device, all 8 chains
    t1 = run(1)
    # two processes, one device each, 4 chains each
    t2 = run(2)
    eff = t1 / (2 * t2)
    row = {"single_proc_s": round(t1, 3), "two_proc_s": round(t2, 3),
           "chain_throughput_scaling_efficiency": round(eff, 3),
           "note": "2 OS processes x 1 CPU device via jax.distributed/gloo; "
                   "cycle has no cross-process traffic (records host-local, "
                   "GRB moments once per cycle)"}
    print(json.dumps(row))
    with open(os.path.join(REPO, "experiments", "chains_scaling_cpu.json"),
              "w") as f:
        json.dump(row, f)


if __name__ == "__main__":
    main()
