"""CPU tests of chip_smoke.py: its device check and its parity helpers.

The script's main path runs only on the GPU; here the device check must
refuse the CPU, and the parity helpers must pass at small n against the
float64 reference."""

import importlib.util
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "not a GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_parity_helpers_small_n():
    import nngp_tpu
    from nngp_tpu.utils.datasets import synthetic_heavy_metals

    locs, y, X = synthetic_heavy_metals(n=1500, n_sites=1350, p=3, seed=4)
    mc = nngp_tpu.initialize(locs, y, X_locs=X, m=5,
                             stationary_covfun="exponential_sphere",
                             n_chains=2, seed=2)
    checks = _chip_smoke().parity_checks(mc, chain=1)
    assert len(checks) == 9
    for name, (err, tol) in checks.items():
        assert np.isfinite(err) and err <= tol, (name, err, tol)
