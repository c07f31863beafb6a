"""Device-side compute kernels (JAX/XLA).

Device-side equivalents of the reference's native (C++/C/LAPACK) numerics —
see SURVEY.md §2b: GpGp::vecchia_Linv / Linv_mult, Matrix sparse ops,
Bessel-K for the Matérn family, and the level-scheduled triangular solve
replacing sequential sparse back-substitution.
"""

from nngp_tpu.ops.covariance import (
    COVFUN_FAMILIES,
    shape_param_names,
    shape_transform,
    correlation_fn,
    correlation_from_sqdist,
    group_sqdist,
    n_range_groups,
)
from nngp_tpu.ops.reductions import df_sum, pairwise_df_sum, two_sum
from nngp_tpu.ops.vecchia import (
    vecchia_linv,
    linv_mult,
    linv_t_mult,
    precision_diag_and_q_edges,
    nngp_loglik,
    nngp_loglik_diff,
)
from nngp_tpu.ops.trisolve import level_solve

__all__ = [
    "COVFUN_FAMILIES",
    "shape_param_names",
    "shape_transform",
    "correlation_fn",
    "correlation_from_sqdist",
    "group_sqdist",
    "n_range_groups",
    "df_sum",
    "pairwise_df_sum",
    "two_sum",
    "vecchia_linv",
    "linv_mult",
    "linv_t_mult",
    "precision_diag_and_q_edges",
    "nngp_loglik",
    "nngp_loglik_diff",
    "level_solve",
]
