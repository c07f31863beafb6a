"""Location reorderings for the Vecchia approximation.

Reference parity: the five reorderings dispatched at
the reference's Scripts/mcmc_nngp_initialize.R:29-33 via GpGp's C++ helpers
(order_maxmin, order_coordinate, order_dist_to_point, order_middleout, or a
random permutation).  These run once on the host, so they are implemented in
chunked NumPy (with an optional C++ fast path for maxmin, see native/).

All functions return an int64 permutation ``perm`` such that
``locs[perm]`` is the reordered location array.
"""

from __future__ import annotations

import numpy as np


def _as_euclidean(locs: np.ndarray, lonlat: bool) -> np.ndarray:
    """Map lon/lat degrees to 3-D unit-sphere coordinates when ``lonlat``.

    Spherical covariance families measure chordal distance on the unit
    sphere (GpGp convention for *_sphere covariance functions); orderings for
    those families use the same geometry (mcmc_nngp_initialize.R:29 passes
    ``lonlat`` to GpGp::order_maxmin).
    """
    if not lonlat:
        return np.asarray(locs, dtype=np.float64)
    return lonlat_to_xyz(locs)


def lonlat_to_xyz(locs: np.ndarray) -> np.ndarray:
    """(lon, lat) in degrees -> points on the unit sphere in R^3."""
    locs = np.asarray(locs, dtype=np.float64)
    lon = np.deg2rad(locs[:, 0])
    lat = np.deg2rad(locs[:, 1])
    cl = np.cos(lat)
    return np.stack([cl * np.cos(lon), cl * np.sin(lon), np.sin(lat)], axis=1)


def order_maxmin(locs: np.ndarray, lonlat: bool = False) -> np.ndarray:
    """Exact farthest-point (maxmin) ordering.

    First point = the one closest to the centroid; each subsequent point
    maximizes its minimum distance to all previously selected points.
    O(n^2) time, O(n) memory via an incrementally maintained min-distance
    vector; chunked inner loop keeps NumPy overhead low.
    """
    x = _as_euclidean(locs, lonlat)
    n = x.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n > 4000:
        from nngp_tpu.utils.native import maxmin_order_native

        perm = maxmin_order_native(x)
        if perm is not None:
            return perm
    centroid = x.mean(axis=0)
    first = int(np.argmin(((x - centroid) ** 2).sum(axis=1)))
    perm = np.empty(n, dtype=np.int64)
    perm[0] = first
    # squared min distance from every point to the selected set
    mind = ((x - x[first]) ** 2).sum(axis=1)
    mind[first] = -np.inf
    for k in range(1, n):
        nxt = int(np.argmax(mind))
        perm[k] = nxt
        d = ((x - x[nxt]) ** 2).sum(axis=1)
        np.minimum(mind, d, out=mind)
        mind[nxt] = -np.inf
    return perm


def order_coordinate(locs: np.ndarray, coordinate: int) -> np.ndarray:
    """Sort by one coordinate (1-based index, matching the R convention at
    mcmc_nngp_initialize.R:31)."""
    locs = np.asarray(locs)
    return np.argsort(locs[:, coordinate - 1], kind="stable").astype(np.int64)


def order_dist_to_point(
    locs: np.ndarray, loc0: np.ndarray, lonlat: bool = False
) -> np.ndarray:
    """Sort by distance to a reference point (closest first)."""
    x = _as_euclidean(locs, lonlat)
    loc0 = np.asarray(loc0, dtype=np.float64).reshape(1, -1)
    if lonlat:
        loc0 = lonlat_to_xyz(loc0)
    d = ((x - loc0) ** 2).sum(axis=1)
    return np.argsort(d, kind="stable").astype(np.int64)


def order_middleout(locs: np.ndarray, lonlat: bool = False) -> np.ndarray:
    """Sort by distance to the centroid (closest first)."""
    x = _as_euclidean(locs, lonlat)
    return order_dist_to_point(x, x.mean(axis=0), lonlat=False)


def order_random(n: int, rng: np.random.Generator) -> np.ndarray:
    return rng.permutation(n).astype(np.int64)


def reorder_locations(
    locs: np.ndarray,
    reordering="maxmin",
    lonlat: bool = False,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Dispatch on the reordering selector.

    ``reordering`` is either a string or a (name, arg) tuple, mirroring the
    string-or-tuple selector of mcmc_nngp_initialize.R:29-33.
    """
    if isinstance(reordering, (tuple, list)):
        name, arg = reordering[0], reordering[1]
    else:
        name, arg = reordering, None
    if name == "maxmin":
        return order_maxmin(locs, lonlat=lonlat)
    if name == "random":
        if rng is None:
            rng = np.random.default_rng(0)
        return order_random(len(locs), rng)
    if name == "coord":
        return order_coordinate(locs, int(arg))
    if name == "dist_to_point":
        return order_dist_to_point(locs, np.asarray(arg, dtype=np.float64), lonlat=lonlat)
    if name == "middleout":
        return order_middleout(locs, lonlat=lonlat)
    raise ValueError(f"unknown reordering {name!r}")
