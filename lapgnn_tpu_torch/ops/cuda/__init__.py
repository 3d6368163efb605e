"""Hand-written Hopper kernels (``csrc/*.cu``) with their plain PyTorch
versions and launch counters."""

from .colmin import col_min, min_trick
from .features import row_features_stats
from .twomin import two_min

__all__ = ["col_min", "min_trick", "row_features_stats", "two_min", "WRAPPERS"]

# Every kernel wrapper; each counts its launches in ``.launches``.
WRAPPERS = (col_min, min_trick, row_features_stats, two_min)
