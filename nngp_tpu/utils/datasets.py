"""Workload loaders.

- ``load_heavy_metals``: the reference's real-data workload — US heavy-metal
  (lead) measurements, 64,274 observations at 58,097 unique lon/lat sites
  with 14 location covariates (the reference's
  Heavy_metals/processed_data.RDS, consumed by
  Heavy_metals/run_script.R:8-15), read from ``DEFAULT_RDS`` inside the
  repository.  Parsed directly from the RDS binary via nngp_tpu.utils.rds.
  While that file is absent the loader warns and returns a synthetic clone
  of the same shape (``synthetic_heavy_metals``: the same counts of
  observations, sites and covariates, repeated sites, and a spatial field
  with the real fit's covariance); ``heavy_metals_source`` says which one a
  run gets.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

DEFAULT_RDS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data", "heavy_metals", "processed_data.RDS",
)


def heavy_metals_source(path: str = DEFAULT_RDS) -> str:
    """"rds" when the real data file is present, else "synthetic"."""
    return "rds" if os.path.exists(path) else "synthetic"


def load_heavy_metals(path: str = DEFAULT_RDS, allow_synthetic: bool = True):
    """Returns (observed_locs [n,2] lon/lat, observed_field [n], X_locs dict)."""
    if heavy_metals_source(path) == "rds":
        from nngp_tpu.utils.rds import read_rds

        d = read_rds(path)
        locs = d["observed_locs"]
        if isinstance(locs, dict) and "__matrix__" in locs:
            locs = locs["__matrix__"]
        y = np.asarray(d["observed_field"], dtype=np.float64)
        X = {
            k: v
            for k, v in d["X_locs"].items()
            if k != "__data.frame__"
        }
        return np.asarray(locs, dtype=np.float64), y, X
    if not allow_synthetic:
        raise FileNotFoundError(path)
    warnings.warn(f"{path} not found: using the same-shape synthetic "
                  "Heavy-metals data", stacklevel=2)
    return synthetic_heavy_metals()


# Covariance of the Heavy-metals fit on the real data
# (experiments/hm_analysis_r4.log): scale, noise variance, and range in km
# over the Earth's radius, i.e. on the unit sphere of exponential_sphere.
_HM_SCALE, _HM_NOISE, _HM_RANGE = 0.2, 0.18, 38.0 / 6371.0
_N_FEATURES = 512


def synthetic_heavy_metals(n: int = 64274, n_sites: int = 58097, p: int = 14,
                           seed: int = 0):
    """Same-shape synthetic workload: ``n`` observations at ``n_sites``
    unique lon/lat sites in the US box (every site observed once, the rest
    repeat sites drawn at random), ``p`` site covariates, and a short-range
    exponential field on the sphere with the real fit's scale, range and
    noise.  The field is a random-Fourier-feature draw: the exponential
    covariance's spectral density is a multivariate t with one degree of
    freedom, so frequencies are Gaussian over |Gaussian| / range."""
    if not 0 < n_sites <= n:
        raise ValueError(f"n_sites={n_sites} must be in 1..n={n}")
    from nngp_tpu.preprocess.ordering import lonlat_to_xyz

    rng = np.random.default_rng(seed)
    sites = np.stack([rng.uniform(-125, -67, n_sites),
                      rng.uniform(25, 49, n_sites)], axis=1)
    site_of = rng.permutation(np.concatenate(
        [np.arange(n_sites), rng.integers(0, n_sites, n - n_sites)]))
    freq = rng.normal(size=(3, _N_FEATURES)) / (
        np.abs(rng.normal(size=_N_FEATURES)) * _HM_RANGE)
    phase = rng.uniform(0, 2 * np.pi, _N_FEATURES)
    field = np.sqrt(2 * _HM_SCALE / _N_FEATURES) * np.cos(
        lonlat_to_xyz(sites) @ freq + phase).sum(axis=1)
    Xs = rng.normal(size=(n_sites, p))
    beta = rng.normal(size=p) * 0.3
    y = (2.0 + Xs @ beta + field)[site_of] + rng.normal(size=n) * np.sqrt(
        _HM_NOISE)
    X = {f"x{j}": Xs[site_of, j] for j in range(p)}
    return sites[site_of], y, X
