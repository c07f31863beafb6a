"""Compensated (double-float) reductions for the MH log-ratios.

At Heavy-metals scale the sampler's accept ratios difference two ~58k-term
float32 reductions whose totals are O(1e4-1e5); naive f32 summation leaves
O(0.1-1) state-dependent noise in the log-ratio, enough to corrupt the
ancillary / sufficient MH blocks (the round-2 divergence,
experiments/ratio_audit_*.json).  The reference computes these in float64
(R doubles, mcmc_nngp_update_Gaussian.R:8-12,129-133,184-186).

The sampler's state is float32, so these give f64-quality sums from f32
ops alone:

- ``two_sum``: Knuth's error-free transformation of a + b.
- ``pairwise_df_sum``: pairwise reduction tree that carries a (hi, lo)
  double-float accumulator per node — error O(eps^2 * n) relative, i.e.
  exact to f32 ulp of the true sum for any n we care about.
- The ratio helpers in models/gaussian.py feed it *per-term differences*
  (new_i - old_i), so the term magnitudes are proposal-sized rather than
  total-sized and the residual per-term rounding (eps * sum|term|) is
  small too.

Cost: ~2n extra elementwise flops per reduction — invisible next to the factor
builds.  Everything is shape-static and jit/vmap-friendly.
"""

from __future__ import annotations

import jax.numpy as jnp


def two_sum(a, b):
    """Error-free transformation: a + b = s + err exactly (Knuth)."""
    s = a + b
    bp = s - a
    err = (a - (s - bp)) + (b - bp)
    return s, err


def _df_add(a_hi, a_lo, b_hi, b_lo):
    """Double-float addition with renormalization."""
    s, e = two_sum(a_hi, b_hi)
    e = e + (a_lo + b_lo)
    hi, lo = two_sum(s, e)
    return hi, lo


def pairwise_df_sum(x):
    """Double-float pairwise sum of a 1-D array -> (hi, lo) with
    hi + lo ~= float64(sum(x)).  Shape-static: pads to the next power of
    two and halves ~log2(n) times; vmap over leading axes as needed."""
    x = x.reshape(-1)
    n = x.shape[0]
    if n == 0:
        z = jnp.zeros((), dtype=x.dtype)
        return z, z
    N = 1 << max(int(n - 1).bit_length(), 0)
    if N != n:
        x = jnp.concatenate([x, jnp.zeros(N - n, dtype=x.dtype)])
    hi = x
    lo = jnp.zeros_like(x)
    while N > 1:
        N //= 2
        hi, lo = _df_add(hi[:N], lo[:N], hi[N:], lo[N:])
    return hi[0], lo[0]


def df_sum(x):
    """Compensated sum collapsed back to one f32 value.

    Safe to *difference* two df_sum results only if the cancellation is
    mild; for MH ratios prefer summing per-term differences instead."""
    hi, lo = pairwise_df_sum(x)
    return hi + lo
