"""VecchiaGraph: the static device-side problem structure.

Bundles every fixed-shape array the device kernels need — the padded neighbor
array, the moralized-graph scatter maps, per-color and per-level padded site
lists, and the observation<->location maps.  Built once on the host
(reference: L1 preprocessing, mcmc_nngp_initialize.R:21-110) and passed to
jitted functions as a pytree argument.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import numpy as np

from nngp_tpu.preprocess.coloring import (
    blocked_groups,
    dag_levels,
    greedy_coloring,
    level_segments,
    moralized_edges,
    padded_groups,
    site_neighbor_lists,
)
from nngp_tpu.preprocess.dedupe import ObsMaps
from nngp_tpu.preprocess.neighbors import find_ordered_nn
from nngp_tpu.preprocess.ordering import lonlat_to_xyz


@dataclass(frozen=True)
class VecchiaGraph:
    # geometry (kernel_coords: coordinates fed to the covariance function —
    # 3-D unit-sphere embedding for *_sphere families, raw otherwise)
    kernel_coords: jax.Array      # f32 [n, d']
    # per-neighbor-set pairwise squared distances by range group, computed
    # in float64 on the host (theta-independent) and stored f32 — the
    # precision-preserving input of the Vecchia factor build
    # (ops/covariance.py group_sqdist)
    nn_dist2: jax.Array           # f32 [n, m+1, m+1, G]
    # Vecchia DAG
    NNarray: jax.Array            # i32 [n, m+1]  (row i = [i, parents...], pad -1)
    nn_mask: jax.Array            # f32 [n, m+1]
    # moralized graph / Q = L'L assembly
    pair_edge_id: jax.Array       # i32 [n, P] -> edge id (sentinel = n_edges)
    nbr_sites: jax.Array          # i32 [n, D]  (pad = n)
    nbr_edge: jax.Array           # i32 [n, D]  (pad = n_edges)
    nbr_mask: jax.Array           # f32 [n, D]
    # chromatic schedule
    colors_idx: jax.Array         # i32 [n_colors, Smax] (pad = n; analysis/tests)
    chrom_blocks: jax.Array       # i32 [n_blocks, B] fixed-width block schedule
    # degree-classed chromatic schedule: per degree class, the block site
    # list plus fully pre-gathered neighbor structure (sites/edges/mask
    # truncated to the class width) — the conditional update then reads
    # only ~avg-degree columns instead of the global max degree
    chrom_sites: tuple            # of i32 [nb_c, B_c]            (pad = n)
    chrom_nbrs: tuple             # of i32 [nb_c, B_c, w_c]       (pad = n)
    chrom_edges: tuple            # of i32 [nb_c, B_c, w_c]       (pad = E)
    chrom_nmask: tuple            # of f32 [nb_c, B_c, w_c]
    # triangular-solve schedule (blocked by DAG level)
    levels_idx: jax.Array         # i32 [n_blocks_l, B_l] (pad = n)
    # tight segment-classed level schedule (ops/trisolve fast path):
    # tuple of i32 [k_s, W_s] tables in topological order, pad = n
    level_segs: tuple
    # observation maps
    locs_match: jax.Array         # i32 [n_obs]
    hctam_scol_1: jax.Array       # i32 [n]
    obs_per_loc: jax.Array        # f32 [n]
    # static metadata
    pair_a: tuple                  # position pairs (a<b) used for Q scatter
    pair_b: tuple
    covfun: str                    # one of the 8 stationary family names
    n_edges: int                   # number of undirected moralized edges
    # floor on the per-row conditional variance d_i in the factor build.
    # 1e-12 (pure numerics) for the exponential families; 1e-5 for the
    # Matern families, where f32 storage of near-unit K entries amplified
    # by 1/d_i (d_i ~ dist^{2 nu} at near-duplicate sites) otherwise puts
    # O(1) noise into the MH log-det ratios (experiments/
    # matern_probe_cpu.json: 51 rows with d<1e-5 carried 13.5 of the 15.6
    # total |error| at HM geometry).  The floor is theta-independent, so
    # rows floored under both states drop out of every MH ratio; it is
    # equivalent to a <=1e-5*scale jitter on nearly-deterministic
    # conditionals (vs. noise/scale ~ 1.75 at HM).
    d_floor: float = 1e-12

    @property
    def n(self) -> int:
        return self.NNarray.shape[0]

    @property
    def m(self) -> int:
        return self.NNarray.shape[1] - 1

    @property
    def n_obs(self) -> int:
        return self.locs_match.shape[0]


jax.tree_util.register_dataclass(
    VecchiaGraph,
    data_fields=[
        "kernel_coords", "nn_dist2", "NNarray", "nn_mask", "pair_edge_id",
        "nbr_sites", "nbr_edge", "nbr_mask", "colors_idx", "chrom_blocks",
        "chrom_sites", "chrom_nbrs", "chrom_edges", "chrom_nmask",
        "levels_idx", "level_segs", "locs_match", "hctam_scol_1",
        "obs_per_loc",
    ],
    meta_fields=["pair_a", "pair_b", "covfun", "n_edges", "d_floor"],
)


def nn_group_sqdist(coords, NN, covfun: str, dtype=np.float32) -> np.ndarray:
    """Per-row pairwise squared distances of each (m+1)-neighbor set, by
    range group: f32 [n, k, k, G].

    Computed in float64 on the host so no coordinate cancellation survives
    into the device factor build (ops/covariance.py group_sqdist); chunked
    over rows to bound peak host memory at large n."""
    from nngp_tpu.ops.covariance import group_sqdist, n_range_groups

    coords = np.asarray(coords, dtype=np.float64)
    NN = np.asarray(NN)
    n, k = NN.shape
    G = n_range_groups(covfun, coords.shape[1])
    out = np.empty((n, k, k, G), dtype=dtype)
    safe = np.maximum(NN, 0)
    chunk = max(1, (64 << 20) // max(1, k * k * coords.shape[1] * 8))
    for lo in range(0, n, chunk):
        pts = coords[safe[lo : lo + chunk]]          # [c, k, d'] f64
        out[lo : lo + chunk] = group_sqdist(pts, covfun)
    return out


def _classed_chromatic(
    colors, nbr_sites, nbr_edge, nbr_mask, n_sentinel, e_sentinel, dtype,
    min_width=8, max_block=4096, min_block=256,
):
    """Degree-classed chromatic schedule with pre-gathered neighbor
    structure (see VecchiaGraph field docs).  Power-of-two width classes;
    per-class block size ~ the typical per-(class,color) group size so
    padding waste stays bounded without exploding the step count."""
    import numpy as np

    deg = nbr_mask.sum(axis=1).astype(np.int64)
    max_deg = int(deg.max()) if deg.size else 1
    n_colors = int(colors.max()) + 1 if colors.size else 1
    widths = []
    w = min_width
    while w < max_deg:
        widths.append(w)
        w *= 2
    widths.append(max(max_deg, min_width))
    # merge classes with few sites into the next one by only keeping
    # boundaries where the class holds >= 5% of sites (the tail class
    # always stays)
    sites_per = []
    prev = -1
    for w in widths:
        sites_per.append(int(((deg > prev) & (deg <= w)).sum()))
        prev = w
    keep = [w for w, s in zip(widths[:-1], sites_per[:-1]) if s >= 0.05 * len(deg)]
    widths = keep + [widths[-1]]

    out_sites, out_nbrs, out_edges, out_mask = [], [], [], []
    prev = -1
    for w in widths:
        sel = np.where((deg > prev) & (deg <= w))[0]
        prev = w
        if sel.size == 0:
            continue
        per_group = max(1, sel.size // max(n_colors, 1))
        B = 1 << int(np.ceil(np.log2(per_group)))
        B = int(min(max_block, max(min_block, B)))
        blocks = blocked_groups(colors[sel], B, n_sentinel=len(sel))
        padded = blocks >= len(sel)
        sites = sel[np.minimum(blocks, len(sel) - 1)].astype(np.int32)
        sites[padded] = n_sentinel
        safe = np.minimum(sites, len(deg) - 1)
        nb = nbr_sites[safe][:, :, :w].copy()
        ed = nbr_edge[safe][:, :, :w].copy()
        mk = nbr_mask[safe][:, :, :w].astype(dtype).copy()
        nb[padded] = n_sentinel
        ed[padded] = e_sentinel
        mk[padded] = 0
        out_sites.append(sites)
        out_nbrs.append(nb)
        out_edges.append(ed)
        out_mask.append(mk)
    return tuple(out_sites), tuple(out_nbrs), tuple(out_edges), tuple(out_mask)


def build_graph(
    obs_maps: ObsMaps,
    m: int,
    covfun: str,
    dtype=np.float32,
    NN: np.ndarray | None = None,
) -> tuple[VecchiaGraph, np.ndarray]:
    """Assemble the VecchiaGraph from deduped/reordered locations.

    Returns (graph, NNarray_numpy).  Covers reference steps
    mcmc_nngp_initialize.R:93-110 plus the triangular solve's level schedule.
    Pass a precomputed ``NN`` (e.g. from a saved fit) to skip the neighbor
    search and rebuild the exact saved DAG deterministically.
    """
    locs = obs_maps.locs
    lonlat = "sphere" in covfun
    if NN is None:
        NN = find_ordered_nn(locs, m, lonlat=lonlat)
    else:
        NN = np.asarray(NN)
        assert NN.shape == (locs.shape[0], m + 1), (NN.shape, locs.shape, m)
    n = NN.shape[0]
    edges, pair_edge_id, pa, pb = moralized_edges(NN)
    nbr_sites, nbr_edge, nbr_mask = site_neighbor_lists(n, edges)
    colors = greedy_coloring(NN)
    colors_idx, _ = padded_groups(colors, n_sentinel=n)
    levels = dag_levels(NN)
    # fixed-width block schedules (see blocked_groups): block sizes sized to
    # keep the device busy while bounding per-group padding waste
    b_chrom = int(min(4096, max(128, n)))
    b_level = int(min(2048, max(128, n)))
    chrom_blocks = blocked_groups(colors, b_chrom, n_sentinel=n)
    levels_idx = blocked_groups(levels, b_level, n_sentinel=n)
    level_segs = level_segments(levels, n_sentinel=n)
    chrom_sites, chrom_nbrs, chrom_edges, chrom_nmask = _classed_chromatic(
        colors, nbr_sites, nbr_edge, nbr_mask, n_sentinel=n,
        e_sentinel=int(edges.shape[0]), dtype=dtype,
    )
    coords = lonlat_to_xyz(locs) if lonlat else locs
    # leaves stay NumPy on the host; the API layer device_puts the whole
    # pytree in one batched transfer before the first jitted cycle
    g = VecchiaGraph(
        kernel_coords=np.asarray(coords, dtype=dtype),
        nn_dist2=nn_group_sqdist(coords, NN, covfun, dtype=dtype),
        NNarray=NN,
        nn_mask=(NN >= 0).astype(dtype),
        pair_edge_id=pair_edge_id,
        nbr_sites=nbr_sites,
        nbr_edge=nbr_edge,
        nbr_mask=nbr_mask.astype(dtype),
        colors_idx=colors_idx,
        chrom_blocks=chrom_blocks,
        chrom_sites=chrom_sites,
        chrom_nbrs=chrom_nbrs,
        chrom_edges=chrom_edges,
        chrom_nmask=chrom_nmask,
        levels_idx=levels_idx,
        level_segs=level_segs,
        locs_match=obs_maps.locs_match,
        hctam_scol_1=obs_maps.hctam_scol_1,
        obs_per_loc=obs_maps.obs_per_loc.astype(dtype),
        pair_a=tuple(int(v) for v in pa),
        pair_b=tuple(int(v) for v in pb),
        covfun=covfun,
        n_edges=int(edges.shape[0]),
        d_floor=1e-5 if covfun.startswith("matern") else 1e-12,
    )
    return g, NN
