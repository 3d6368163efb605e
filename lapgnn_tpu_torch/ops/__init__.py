"""Tensor ops of the port: dual math, features, seed policy, and the
hand-written CUDA kernels under ``ops.cuda``."""

from .dual import (
    BIG,
    center_gauge,
    check_complementary_slackness,
    check_dual_feasible,
    dual_objective,
    duals_from_matching,
    masked_fill,
    min_trick_v,
    project_feasible,
    reduced_costs,
    tighten_rows,
)

__all__ = [
    "BIG",
    "center_gauge",
    "check_complementary_slackness",
    "check_dual_feasible",
    "dual_objective",
    "duals_from_matching",
    "masked_fill",
    "min_trick_v",
    "project_feasible",
    "reduced_costs",
    "tighten_rows",
]
