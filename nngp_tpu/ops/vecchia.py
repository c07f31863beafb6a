"""Batched Vecchia sparse inverse-Cholesky kernels.

The #1 hot path of the sampler (SURVEY.md §2b N3/N4/N7).  Batched
re-design of GpGp::vecchia_Linv / GpGp::Linv_mult / Matrix::crossprod
(reference call sites: mcmc_nngp_initialize.R:201,
mcmc_nngp_update_Gaussian.R:8-12,72-74,123,179, mcmc_nngp_predict.R:39):

- ``vecchia_linv``: for every site i simultaneously, gather the (m+1)
  neighbor coordinates, form the (m+1)x(m+1) correlation matrix, factor it
  and produce row i of the compressed factor L — all as one fused, fully
  vectorized computation over the padded [n, m+1] neighbor array.  The tiny
  per-row Cholesky/solves are *unrolled* over the static neighbor count so
  the whole kernel is straight-line elementwise code (no batched-LAPACK
  loops).
- ``linv_mult`` / ``linv_t_mult``: gather/scatter mat-vecs with L and L'.
- ``precision_diag_and_q_edges``: the nonzeros of Q = L'L (diagonal +
  moralized-edge values) by one scatter-add over precomputed edge-id maps —
  replaces the reference's repeated sparse crossprod
  (mcmc_nngp_update_Gaussian.R:74,269).
- ``nngp_loglik``: the Vecchia Gaussian log-likelihood
  (ll_compressed_sparse_chol, mcmc_nngp_update_Gaussian.R:8-12).

Compressed-row convention (same as GpGp): row i of L has entries at columns
NNarray[i, :] = [i, parents...]; linv[i, 0] is the diagonal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nngp_tpu.ops.covariance import (
    correlation_fn,
    correlation_from_sqdist,
    exp_acc,
    log1p_acc,
)


def _unrolled_cholesky(K: jax.Array, k: int) -> list:
    """Cholesky of [..., k, k] SPD matrices, unrolled over the static size k.

    Returns the lower factor as a k x k list of [...]-shaped arrays (None
    above the diagonal).  O(k^3/6) elementwise ops, vectorized over the
    leading batch dimensions.
    """
    L = [[None] * k for _ in range(k)]
    for j in range(k):
        s = K[..., j, j]
        for t in range(j):
            s = s - L[j][t] * L[j][t]
        L[j][j] = jnp.sqrt(jnp.maximum(s, 1e-12))
        inv_ljj = 1.0 / L[j][j]
        for i in range(j + 1, k):
            s = K[..., i, j]
            for t in range(j):
                s = s - L[i][t] * L[j][t]
            L[i][j] = s * inv_ljj
    return L


def _forward_solve(L: list, b: list, k: int) -> list:
    """Solve L y = b with the unrolled lower factor; b is a list of [...]."""
    y = [None] * k
    for i in range(k):
        s = b[i]
        for t in range(i):
            s = s - L[i][t] * y[t]
        y[i] = s / L[i][i]
    return y


def _backward_solve(L: list, y: list, k: int) -> list:
    """Solve L' z = y."""
    z = [None] * k
    for i in range(k - 1, -1, -1):
        s = y[i]
        for t in range(i + 1, k):
            s = s - L[t][i] * z[t]
        z[i] = s / L[i][i]
    return z


def linv_rows_from_K(K: jax.Array, mask: jax.Array,
                     d_floor: float = 1e-12) -> jax.Array:
    """Compressed factor rows [..., m+1] from neighbor-set correlation
    matrices K [..., m+1, m+1] and validity mask [..., m+1] — the shared
    conditional-Gaussian math of :func:`vecchia_linv` (batched, unrolled
    over the static neighbor count).  ``d_floor`` bounds the conditional
    variance below (see VecchiaGraph.d_floor for the family-aware
    rationale)."""
    k = K.shape[-1]
    m = k - 1
    # force padded rows/cols to identity
    valid2 = mask[..., :, None] * mask[..., None, :]
    eye = jnp.eye(k, dtype=K.dtype)
    K = K * valid2 + eye * (1.0 - valid2)
    if m == 0:
        return jnp.ones(K.shape[:-2] + (1,), dtype=K.dtype)
    # conditional of position 0 given positions 1..m
    Knn = K[..., 1:, 1:]
    L = _unrolled_cholesky(Knn, m)
    kni = [K[..., 1 + j, 0] for j in range(m)]
    u = _forward_solve(L, kni, m)
    d = K[..., 0, 0]
    for j in range(m):
        d = d - u[j] * u[j]
    d = jnp.maximum(d, d_floor)
    b = _backward_solve(L, u, m)
    inv_sqrt_d = jax.lax.rsqrt(d)
    rows = [inv_sqrt_d] + [
        -b[j] * inv_sqrt_d * mask[..., 1 + j] for j in range(m)
    ]
    return jnp.stack(rows, axis=-1)


def vecchia_linv(graph, natural_shape: jax.Array) -> jax.Array:
    """Compressed sparse inverse-Cholesky factor, rows = [n, m+1].

    Row i encodes the conditional N(x_i | x_parents):
      linv[i, 0]   = 1/sqrt(d_i)
      linv[i, 1:j] = -b_ij / sqrt(d_i)
    where b = Knn^-1 Kni and d = 1 - Kni' b.  Padded parent slots produce
    exact zeros (their covariance rows are forced to identity).
    """
    NN = graph.NNarray
    mask = graph.nn_mask
    nn_d2 = getattr(graph, "nn_dist2", None)
    if nn_d2 is not None:
        # precision-preserving path: per-neighbor-set squared distances were
        # computed in f64 on the host (theta-independent geometry), so no
        # coordinate cancellation enters the factor (ops/covariance.py
        # group_sqdist rationale; fixes the r2 Heavy-metals divergence)
        K = correlation_from_sqdist(graph.covfun, nn_d2, natural_shape)
    else:
        safe_pts = jnp.maximum(NN, 0)
        pts = jnp.asarray(graph.kernel_coords)[safe_pts]   # [n, k, d']
        corr = correlation_fn(graph.covfun)
        K = corr(pts, natural_shape)                 # [n, k, k]
    return linv_rows_from_K(K, mask, getattr(graph, "d_floor", 1e-12))


def linv_mult(linv: jax.Array, x: jax.Array, graph) -> jax.Array:
    """y = L x over the compressed rows (GpGp::Linv_mult,
    mcmc_nngp_update_Gaussian.R:10).  x: [n] or [n, c]."""
    safe_NN = jnp.maximum(graph.NNarray, 0)
    if x.ndim == 1:
        vals = x[safe_NN] * graph.nn_mask            # [n, k]
        return jnp.sum(linv * vals, axis=1)
    vals = x[safe_NN] * graph.nn_mask[..., None]      # [n, k, c]
    # HIGHEST: keep the contraction in true f32 (at the default precision
    # a float32 contraction may round its operands, to TF32 on tensor
    # cores; this feeds the beta interweaving precision matrix,
    # mcmc_nngp_update_Gaussian.R:79)
    return jnp.einsum("nk,nkc->nc", linv, vals,
                      precision=jax.lax.Precision.HIGHEST)


def linv_t_mult(linv: jax.Array, z: jax.Array, graph) -> jax.Array:
    """y = L' z via scatter-add over the compressed rows."""
    safe_NN = jnp.maximum(graph.NNarray, 0)
    vals = linv * graph.nn_mask * z[:, None]
    return jnp.zeros(graph.n, dtype=z.dtype).at[safe_NN].add(vals)


def precision_diag_and_q_edges(linv: jax.Array, graph):
    """Nonzeros of Q = L'L: (diagonal [n], moralized-edge values [E+1]).

    The trailing slot of the edge buffer is the sentinel accumulator for
    padded position pairs; reads through graph.nbr_edge mask it out.
    Replaces Matrix::crossprod at mcmc_nngp_update_Gaussian.R:74 and the
    per-color sparse crossprod at :269.
    """
    safe_NN = jnp.maximum(graph.NNarray, 0)
    masked = linv * graph.nn_mask
    pdiag = jnp.zeros(graph.n, dtype=linv.dtype).at[safe_NN].add(masked * masked)
    pa = jnp.asarray(graph.pair_a, dtype=jnp.int32)
    pb = jnp.asarray(graph.pair_b, dtype=jnp.int32)
    prods = masked[:, pa] * masked[:, pb]            # [n, P]
    q_edges = (
        jnp.zeros(graph.n_edges + 1, dtype=linv.dtype)
        .at[graph.pair_edge_id]
        .add(prods)
    )
    return pdiag, q_edges


def nngp_loglik(linv: jax.Array, field: jax.Array, graph, log_scale) -> jax.Array:
    """Vecchia log-density of a centered field under scale exp(log_scale).

    Matches ll_compressed_sparse_chol (mcmc_nngp_update_Gaussian.R:8-12):
      sum(log diag(L)) - n/2 log_scale - 0.5 ||L field||^2 / exp(log_scale)
    (the -n/2 log(2 pi) constant is dropped there too; only ratios matter).
    """
    z = linv_mult(linv, field, graph)
    return (
        jnp.sum(jnp.log(linv[:, 0]))
        - 0.5 * graph.n * log_scale
        - 0.5 * jnp.sum(z * z) * jnp.exp(-log_scale)
    )


def nngp_loglik_diff(linv_new, log_scale_new, linv_old, log_scale_old,
                     field, graph):
    """nngp_loglik(new) - nngp_loglik(old) as ONE compensated reduction of
    per-site differences.

    At n~58k a naive f32 difference of two ~1e4-magnitude log-likelihood
    totals carries O(0.1-1) noise in the MH accept ratio (the reference's
    R doubles have no such problem, mcmc_nngp_update_Gaussian.R:184-186).
    Per-term differencing keeps each summand proposal-sized and the
    double-float pairwise sum (ops/reductions.py) removes accumulation
    error; residual error is O(eps * sum|per-term diff|) ~ 1e-3.
    """
    from nngp_tpu.ops.reductions import df_sum

    z_new = linv_mult(linv_new, field, graph)
    z_old = linv_mult(linv_old, field, graph)
    c_new = exp_acc(-log_scale_new)
    c_old = exp_acc(-log_scale_old)
    # log(a/b) for a ~ b via log1p((a-b)/b): the subtraction is exact
    # (Sterbenz) and log1p_acc is ~1-ulp near 0, so no builtin's
    # systematic bias can accumulate over the n terms
    a, b = linv_new[:, 0], linv_old[:, 0]
    terms = (
        log1p_acc((a - b) / b)
        - 0.5 * (z_new * z_new * c_new - z_old * z_old * c_old)
    )
    return df_sum(terms) - 0.5 * graph.n * (log_scale_new - log_scale_old)
