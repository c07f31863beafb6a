"""Tests for the RDS reader, dataset loaders, native fast paths, and the
alias package."""

import os

import numpy as np
import pytest

from nngp_tpu.utils.datasets import DEFAULT_RDS as RDS_PATH


@pytest.mark.skipif(not os.path.exists(RDS_PATH), reason="reference data absent")
def test_rds_reader_heavy_metals():
    from nngp_tpu.utils.rds import read_rds

    d = read_rds(RDS_PATH)
    locs = d["observed_locs"]["__matrix__"]
    assert locs.shape == (64274, 2)
    assert d["observed_locs"]["colnames"] == ["coords.x1", "coords.x2"]
    y = np.asarray(d["observed_field"])
    assert y.shape == (64274,) and np.isfinite(y).all()
    cols = [c for c in d["X_locs"] if c != "__data.frame__"]
    assert len(cols) == 14
    # lon/lat ranges plausible for the US
    assert locs[:, 0].min() > -180 and locs[:, 0].max() < 0
    assert 15 < locs[:, 1].min() and locs[:, 1].max() < 75


def test_load_heavy_metals_or_synthetic():
    from nngp_tpu.utils.datasets import load_heavy_metals

    locs, y, X = load_heavy_metals()
    assert locs.shape[1] == 2
    assert len(y) == len(locs)
    assert len(X) == 14
    for v in X.values():
        assert len(np.asarray(v)) == len(y)


def test_synthetic_heavy_metals_repeats_sites():
    from nngp_tpu.utils.datasets import synthetic_heavy_metals

    locs, y, X = synthetic_heavy_metals(n=3000, n_sites=2700, p=4, seed=1)
    uniq, first, inv = np.unique(locs, axis=0, return_index=True,
                                 return_inverse=True)
    assert len(y) == 3000 and len(uniq) == 2700 and np.isfinite(y).all()
    inv = inv.ravel()
    assert np.bincount(inv).max() > 1
    # location covariates take one value per site
    for v in X.values():
        assert np.array_equal(v, v[first][inv])


def test_native_matches_numpy(rng):
    from nngp_tpu.utils.native import greedy_coloring_native, maxmin_order_native
    from nngp_tpu.preprocess.ordering import order_maxmin
    from nngp_tpu.preprocess.neighbors import find_ordered_nn
    from nngp_tpu.preprocess.coloring import moralized_adjacency, greedy_coloring

    x = rng.uniform(size=(600, 2))
    native = maxmin_order_native(x)
    if native is None:
        pytest.skip("native library unavailable")
    assert np.array_equal(native, order_maxmin(x))
    NN = find_ordered_nn(x, 5)
    A = moralized_adjacency(NN)
    cn = greedy_coloring_native(A.indptr, A.indices, 600)
    assert np.array_equal(cn, greedy_coloring(NN))


def test_alias_package():
    import improving_performances_of_mcmc_for_nearest_neighbor_gaussian_process_models_with_full_data_augmentat_tpu as alias
    import nngp_tpu

    assert alias.initialize is nngp_tpu.initialize
    from improving_performances_of_mcmc_for_nearest_neighbor_gaussian_process_models_with_full_data_augmentat_tpu.models import (  # noqa: E501
        gaussian,
    )

    assert hasattr(gaussian, "run_cycle")


def test_rds_roundtrip_synthetic_types(tmp_path):
    """Exercise the RDS reader against a hand-built XDR stream containing
    the supported SEXP types."""
    import gzip
    import struct

    def u32(x):
        return struct.pack(">I", x)

    def i32(x):
        return struct.pack(">i", x)

    def f64(x):
        return struct.pack(">d", x)

    def charsxp(s):
        b = s.encode()
        return u32(9) + i32(len(b)) + b

    # list(a=1.5, b=2L) — VECSXP with names attribute
    payload = b"X\n" + u32(2) + u32(0x30000) + u32(0x20000)
    # VECSXP, 2 elements, has attributes
    payload += u32(19 | 0x200) + i32(2)
    payload += u32(14) + i32(1) + f64(1.5)          # REALSXP [1.5]
    payload += u32(13) + i32(1) + i32(2)             # INTSXP [2]
    # attribute pairlist: names -> c("a","b")
    payload += u32(2 | 0x400)                        # LISTSXP with tag
    payload += u32(1) + charsxp("names")             # SYMSXP "names"
    payload += u32(16) + i32(2) + charsxp("a") + charsxp("b")
    payload += u32(254)                              # NILVALUE terminator
    path = tmp_path / "t.rds"
    path.write_bytes(gzip.compress(payload))

    from nngp_tpu.utils.rds import read_rds

    d = read_rds(str(path))
    assert d["a"][0] == 1.5
    assert d["b"][0] == 2


@pytest.mark.parametrize("env_set", [True, False])
def test_compilation_cache_placement(monkeypatch, tmp_path, env_set):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own reading of it stands
    and no directory is set; without it the cache goes to the one fixed
    directory inside the checkout."""
    import jax

    from nngp_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: calls.append((name, val)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable_compilation_cache() == str(tmp_path)
        assert calls == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = compile_cache.enable_compilation_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", got)]
        assert os.path.isdir(got)
