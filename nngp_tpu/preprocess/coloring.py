"""Moralized-graph machinery: edges, greedy coloring, DAG levels.

Reference parity:
- MRF adjacency by moralization  crossprod(L)       (mcmc_nngp_initialize.R:103)
- naive greedy coloring                              (Scripts/Coloring.R:2-20)
- (new) DAG level schedule for the batched sparse triangular solve that
  replaces Matrix::solve(L, v) (mcmc_nngp_initialize.R:208,
  mcmc_nngp_update_Gaussian.R:127, mcmc_nngp_predict.R:46).

Everything here is host-side NumPy producing static padded index arrays:
- undirected edge list of the moralized graph + a per-row scatter map used to
  assemble the nonzeros of Q = L'L on device in one scatter-add;
- per-site padded neighbor lists (sites + edge ids) for the chromatic
  conditional-mean gather;
- per-color and per-level padded site lists (sentinel = n) so color/level
  loops are fixed-shape `lax.fori_loop`s on device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _pair_positions(k: int) -> tuple[np.ndarray, np.ndarray]:
    """All position pairs (a < b) of a length-k row."""
    a, b = np.triu_indices(k, k=1)
    return a.astype(np.int64), b.astype(np.int64)


def moralized_edges(NNarray: np.ndarray):
    """Undirected edges of the moralized Vecchia DAG, plus the scatter map.

    Returns
    -------
    edges : int32 [E, 2]      (r < c, lexicographically sorted)
    pair_edge_id : int32 [n, P]   P = (m+1)m/2; entry = edge id of the
        position pair (a, b) in row i, or E (sentinel) when either position
        is padding.  Scatter-adding linv[:, a]*linv[:, b] with this map into a
        length-(E+1) buffer yields the off-diagonal nonzeros of Q = L'L.
    pair_a, pair_b : int64 [P]    static position indices of the pairs.
    """
    NN = np.asarray(NNarray, dtype=np.int64)
    n, k = NN.shape
    pa, pb = _pair_positions(k)
    r = NN[:, pa]  # [n, P]
    c = NN[:, pb]
    valid = (r >= 0) & (c >= 0)
    lo = np.minimum(r, c)
    hi = np.maximum(r, c)
    key = np.where(valid, lo * n + hi, -1)
    uniq, inv = np.unique(key.ravel(), return_inverse=True)
    # uniq[0] == -1 iff any invalid pair exists
    has_pad = uniq.size > 0 and uniq[0] == -1
    E = uniq.size - (1 if has_pad else 0)
    edge_keys = uniq[1:] if has_pad else uniq
    edges = np.stack([edge_keys // n, edge_keys % n], axis=1).astype(np.int32)
    ids = inv.reshape(n, pa.size)
    if has_pad:
        ids = ids - 1
        ids = np.where(ids < 0, E, ids)
    return edges, ids.astype(np.int32), pa, pb


def site_neighbor_lists(n: int, edges: np.ndarray):
    """Padded per-site neighbor lists from the undirected edge list.

    Returns (nbr_sites [n, D], nbr_edge [n, D], nbr_mask [n, D]); pad site
    index = n, pad edge index = E.
    """
    E = edges.shape[0]
    src = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int64)
    dst = np.concatenate([edges[:, 1], edges[:, 0]]).astype(np.int64)
    eid = np.concatenate([np.arange(E), np.arange(E)]).astype(np.int64)
    order = np.argsort(src, kind="stable")
    src, dst, eid = src[order], dst[order], eid[order]
    deg = np.bincount(src, minlength=n)
    D = int(deg.max()) if n else 0
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    nbr_sites = np.full((n, max(D, 1)), n, dtype=np.int32)
    nbr_edge = np.full((n, max(D, 1)), E, dtype=np.int32)
    slot = np.arange(len(src)) - np.repeat(starts, deg)
    nbr_sites[src, slot] = dst.astype(np.int32)
    nbr_edge[src, slot] = eid.astype(np.int32)
    nbr_mask = nbr_sites < n
    return nbr_sites, nbr_edge, nbr_mask


def moralized_adjacency(NNarray: np.ndarray):
    """scipy CSR adjacency of the moralized graph (no diagonal).

    Host-side only; used by the greedy coloring and by tests.
    """
    from scipy import sparse

    NN = np.asarray(NNarray, dtype=np.int64)
    n = NN.shape[0]
    edges, _, _, _ = moralized_edges(NN)
    r = np.concatenate([edges[:, 0], edges[:, 1]])
    c = np.concatenate([edges[:, 1], edges[:, 0]])
    A = sparse.csr_matrix(
        (np.ones(len(r), dtype=np.int8), (r, c)), shape=(n, n)
    )
    return A


def greedy_coloring(NNarray: np.ndarray) -> np.ndarray:
    """Sequential greedy coloring of the moralized graph.

    Same scheme as Scripts/Coloring.R:2-20 (first-fit in site order); colors
    are 0-based ints.  Proper coloring => all sites of one color are
    conditionally independent given the rest, which is what makes the
    chromatic Gibbs block update valid.
    """
    A = moralized_adjacency(NNarray)
    n = A.shape[0]
    indptr, indices = A.indptr, A.indices
    if n > 4000:
        from nngp_tpu.utils.native import greedy_coloring_native

        colors = greedy_coloring_native(indptr, indices, n)
        if colors is not None:
            return colors
    colors = np.full(n, -1, dtype=np.int32)
    for i in range(n):
        nb = indices[indptr[i] : indptr[i + 1]]
        used = colors[nb]
        used = used[used >= 0]
        if used.size == 0:
            colors[i] = 0
            continue
        taken = np.zeros(used.max() + 2, dtype=bool)
        taken[used] = True
        colors[i] = int(np.argmin(taken))
    return colors


def padded_groups(labels: np.ndarray, n_sentinel: int):
    """Group site indices by integer label into a padded [G, Smax] array.

    Pad value = ``n_sentinel`` (device code uses it to write into a dummy
    slot of a length n+1 buffer).
    """
    labels = np.asarray(labels)
    n = labels.shape[0]
    if n == 0:
        return np.zeros((0, 1), dtype=np.int32), np.zeros(0, dtype=np.int32)
    G = int(labels.max()) + 1
    counts = np.bincount(labels, minlength=G)
    Smax = int(counts.max())
    out = np.full((G, Smax), n_sentinel, dtype=np.int32)
    order = np.argsort(labels, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(n) - np.repeat(starts, counts)
    out[labels[order], slot] = order.astype(np.int32)
    return out, counts.astype(np.int32)


def blocked_groups(labels: np.ndarray, block: int, n_sentinel: int):
    """Fixed-width block schedule: sites grouped by label, each group split
    into chunks of ``block`` (pad = n_sentinel), groups in label order.

    Replaces the pad-to-largest-group schedule: total padded work is
    n + n_groups*block/2 instead of n_groups * max_group — the dominant
    gather-traffic saving for the chromatic sweeps and the level solve.
    Correctness requires only that sites with different labels never share
    a block (they never do) and that blocks execute in label order (the
    fori_loop is sequential).  Sites sharing a label are mutually
    independent, so splitting them across sequential blocks is exact.
    """
    labels = np.asarray(labels)
    n = labels.shape[0]
    if n == 0:
        return np.zeros((0, block), dtype=np.int32)
    order = np.argsort(labels, kind="stable").astype(np.int64)
    G = int(labels.max()) + 1
    counts = np.bincount(labels, minlength=G)
    rows = []
    pos = 0
    for g in range(G):
        sites = order[pos : pos + counts[g]]
        pos += counts[g]
        for lo in range(0, len(sites), block):
            chunk = sites[lo : lo + block]
            row = np.full(block, n_sentinel, dtype=np.int32)
            row[: len(chunk)] = chunk
            rows.append(row)
    return np.stack(rows, axis=0)


def degree_classed_blocks(
    colors: np.ndarray,
    degrees: np.ndarray,
    block: int,
    n_sentinel: int,
    min_width: int = 8,
):
    """Chromatic block schedule bucketed by neighbor-degree class.

    Sites are partitioned by (color, degree class) where classes are
    power-of-two widths >= ``min_width``; each class gets its own
    fixed-width block schedule.  The per-color conditional update then
    gathers only ``width`` neighbor columns for each class instead of the
    global max degree — the dominant gather-traffic saving when the degree
    distribution is long-tailed (moralized Vecchia graphs: average degree
    ~2-3x m, max degree can be 10x more).

    Correctness: every block is monochromatic, hence an independent set of
    the moralized graph, and blocks execute sequentially — any such
    schedule is a valid systematic-scan Gibbs sweep; sites update exactly
    once per sweep.

    Returns a list of (width, blocks[int32 nb, block]) pairs.
    """
    colors = np.asarray(colors)
    degrees = np.asarray(degrees)
    max_deg = int(degrees.max()) if degrees.size else 1
    widths = []
    w = min_width
    while w < max_deg:
        widths.append(w)
        w *= 2
    widths.append(max(max_deg, min_width))
    out = []
    prev = -1
    for w in widths:
        sel = np.where((degrees > prev) & (degrees <= w))[0]
        prev = w
        if sel.size == 0:
            continue
        blocks = blocked_groups(colors[sel], block, n_sentinel=len(sel))
        # map subset-relative indices back to global site ids
        padded = blocks >= len(sel)
        glob = sel[np.minimum(blocks, len(sel) - 1)].astype(np.int32)
        glob[padded] = n_sentinel
        out.append((int(w), glob))
    return out


def dag_levels(NNarray: np.ndarray) -> np.ndarray:
    """Topological depth of each site in the Vecchia DAG.

    level[i] = 0 if site i has no parents, else 1 + max(level of parents).
    All sites of one level can be solved simultaneously in the triangular
    solve L x = v (parents always precede children in the ordering).
    Computed by vectorized fix-point iteration: each pass propagates levels
    one step deeper, so it terminates in depth+1 passes.
    """
    NN = np.asarray(NNarray, dtype=np.int64)
    n, k = NN.shape
    parents = NN[:, 1:]
    valid = parents >= 0
    safe = np.where(valid, parents, 0)
    level = np.zeros(n, dtype=np.int64)
    while True:
        pl = np.where(valid, level[safe], -1)
        new = pl.max(axis=1) + 1 if k > 1 else np.zeros(n, dtype=np.int64)
        if k > 1:
            new = np.maximum(new, 0)
        if np.array_equal(new, level):
            return level.astype(np.int32)
        level = new


def level_segments(levels: np.ndarray, n_sentinel=None, small: int = 128,
                   wide: int = 512):
    """Tight *segment-classed* schedule for the level solve.

    Returns a tuple of i32 tables, each ``[k, W]`` with ``W`` one of
    ``(small, wide)``: walking the tables in order and the rows of each
    table top-to-bottom visits every DAG level in topological order, each
    level padded (pad = ``n_sentinel``) only to its class width.  Narrow
    levels (``count <= small``) use the ``small`` class; all others are
    chunked into ``wide``-wide rows; maximal runs of consecutive same-class
    levels are stacked into one table so the solve is a handful of
    ``fori_loop``s over fixed-width tables — the same program structure as
    the ``blocked_groups`` fallback, at ~1.2-1.3x n gathered rows instead
    of its 3-4x n (52 of 96 2048-wide blocks carry <256 real rows at
    Heavy-metals scale).

    Why not one exact-width slice per level: a fully unrolled schedule
    (one mixed-width gather/scatter pair per level, 83 levels at
    Heavy-metals scale) gathers only ~1.05x n rows, but it puts one
    distinct gather/scatter pair per level into the program, and composed
    into the full Gibbs program it crashed the device it was first built
    for.  Segment count here is data-dependent but small (3 at
    Heavy-metals scale: the level-width profile is unimodal).
    """
    levels = np.asarray(levels)
    n = levels.shape[0]
    if n_sentinel is None:
        n_sentinel = n
    if n == 0:
        return ()
    order = np.argsort(levels, kind="stable").astype(np.int64)
    counts = np.bincount(levels, minlength=int(levels.max()) + 1)
    segs, pos = [], 0  # list of [W, list-of-[k_i, W] tables]
    for c in counts:
        sites = order[pos : pos + c]
        pos += c
        if c == 0:
            continue
        W = small if c <= small else wide
        k = -(-c // W)
        tab = np.full((k, W), n_sentinel, dtype=np.int32)
        tab.reshape(-1)[:c] = sites
        if segs and segs[-1][0] == W:
            segs[-1][1].append(tab)
        else:
            segs.append([W, [tab]])
    return tuple(np.concatenate(tabs, axis=0) for _, tabs in segs)
