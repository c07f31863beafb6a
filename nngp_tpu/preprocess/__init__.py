"""Host-side preprocessing (NumPy): runs once per problem.

Produces only static, fixed-shape integer/float arrays so that every
downstream computation is shape-stable and jittable.
"""

from nngp_tpu.preprocess.ordering import reorder_locations
from nngp_tpu.preprocess.neighbors import find_ordered_nn
from nngp_tpu.preprocess.coloring import (
    moralized_adjacency,
    greedy_coloring,
    dag_levels,
)
from nngp_tpu.preprocess.graph import VecchiaGraph, build_graph
from nngp_tpu.preprocess.design import build_design

__all__ = [
    "reorder_locations",
    "find_ordered_nn",
    "moralized_adjacency",
    "greedy_coloring",
    "dag_levels",
    "VecchiaGraph",
    "build_graph",
    "build_design",
]
