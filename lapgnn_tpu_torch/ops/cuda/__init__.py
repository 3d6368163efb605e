"""Hand-written Hopper kernels (``csrc/*.cu``) with their plain PyTorch
versions and launch counters."""

from .arr import arr_auction
from .augment import augment_sweep
from .colmin import col_min, min_trick
from .features import row_features_stats
from .greedy import greedy_total
from .greedy_match import greedy_match
from .sinkhorn import sinkhorn_ladder
from .twomin import two_min

__all__ = [
    "arr_auction",
    "augment_sweep",
    "col_min",
    "greedy_match",
    "greedy_total",
    "min_trick",
    "row_features_stats",
    "sinkhorn_ladder",
    "two_min",
    "WRAPPERS",
]

# Every kernel wrapper; each counts its launches in ``.launches``.
WRAPPERS = (col_min, min_trick, row_features_stats, two_min, greedy_total, augment_sweep,
            arr_auction, greedy_match, sinkhorn_ladder)
