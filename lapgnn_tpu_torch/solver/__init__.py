"""LAP solver layer: the device JV (cold and seeded), the native host
solvers, the solver classes and the cross-solver gate."""

from .jv import (
    Matching,
    augment_all,
    augment_all_multisource,
    column_reduction,
    lapjv_batch,
    lapjv_single,
    matching_cost,
)
from .seeded import (
    SeededResult,
    default_tight_eps,
    greedy_tight_matching,
    lapjv_seeded_batch,
    lapjv_seeded_single,
)

__all__ = [
    "Matching",
    "augment_all",
    "augment_all_multisource",
    "column_reduction",
    "lapjv_batch",
    "lapjv_single",
    "matching_cost",
    "SeededResult",
    "default_tight_eps",
    "greedy_tight_matching",
    "lapjv_seeded_batch",
    "lapjv_seeded_single",
]
