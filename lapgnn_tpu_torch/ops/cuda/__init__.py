"""Hand-written Hopper kernels (``csrc/*.cu``) with their plain PyTorch
versions.  Each wrapper counts its launches in the tracer's counter
``launch.<wrapper name>`` (``tracing.counters()``)."""

from .arr import arr_auction
from .augment import augment_sweep
from .colmin import col_min, min_trick
from .dual_edge import dual_edge_terms
from .features import row_features_stats
from .graph_features import graph_features
from .greedy import greedy_total
from .greedy_match import greedy_match
from .sinkhorn import sinkhorn_ladder
from .twomin import two_min

__all__ = [
    "arr_auction",
    "augment_sweep",
    "col_min",
    "dual_edge_terms",
    "graph_features",
    "greedy_match",
    "greedy_total",
    "min_trick",
    "row_features_stats",
    "sinkhorn_ladder",
    "two_min",
]
