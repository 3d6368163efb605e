"""Synthetic training instances: cost, optimal matching and oracle duals.

Port of ``lapgnn_tpu/data/synthetic.py`` (numpy and SciPy): draw a cost
matrix from a family, solve it with SciPy's ``linear_sum_assignment``,
reconstruct optimal duals by difference constraints
(``ops.host_dual.duals_from_matching_np``), and optionally perturb the duals
with Gaussian noise and project them back to feasibility.
``instance_record`` turns an instance into the dict the trainers' batchers
read, as ``data.h5io.H5Reader`` returns it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import scipy.optimize

from ..ops.host_dual import (
    duals_from_matching_np,
    make_feasible_duals_np,
    project_feasible_np,
)
from .generators import FAMILIES

__all__ = ["SyntheticInstance", "generate_synthetic_instance", "instance_record"]


@dataclass
class SyntheticInstance:
    """One labelled LAP instance."""

    cost: np.ndarray
    rows: np.ndarray
    cols: np.ndarray
    u: np.ndarray
    v: np.ndarray
    family: str
    size: int
    noise_std: float
    tag: Optional[str] = None


def generate_synthetic_instance(
    family: str,
    n: int,
    rng: Optional[np.random.Generator] = None,
    noise_probability: float = 0.2,
    noise_std: float = 0.15,
    dual_noise_prob: float = 0.0,
) -> SyntheticInstance:
    """Generate one labelled instance.

    ``noise_probability`` does nothing; it is kept for the JAX signature.
    Label noise is set by ``dual_noise_prob`` and ``noise_std``.
    """
    if family not in FAMILIES:
        raise KeyError(f"Unknown family '{family}'. Known: {sorted(FAMILIES)}")
    rng = rng or np.random.default_rng(0)

    cost = np.asarray(FAMILIES[family](n, rng), dtype=np.float64)
    rows, cols = scipy.optimize.linear_sum_assignment(cost)
    try:
        u, v, _ = duals_from_matching_np(cost, rows, cols)
    except (AssertionError, RuntimeError):
        u, v = make_feasible_duals_np(cost)

    applied_noise = 0.0
    if dual_noise_prob > 0.0 and rng.random() < dual_noise_prob:
        applied_noise = noise_std
        u = u + rng.normal(0.0, noise_std, size=u.shape)
        v = v + rng.normal(0.0, noise_std, size=v.shape)
        u, v = project_feasible_np(cost, u, v, max_rounds=75)

    return SyntheticInstance(
        cost=cost,
        rows=rows.astype(np.int32),
        cols=cols.astype(np.int32),
        u=u.astype(np.float64),
        v=v.astype(np.float64),
        family=family,
        size=int(n),
        noise_std=float(applied_noise),
        tag=None,
    )


def instance_record(inst: SyntheticInstance) -> Dict[str, Any]:
    """The instance as the record ``H5Reader.__getitem__`` returns: keys
    ``cost u v rows cols opt_cost n family``, the optimal cost summed over
    the matching in float64."""
    return {
        "cost": np.asarray(inst.cost, np.float64),
        "u": np.asarray(inst.u, np.float64),
        "v": np.asarray(inst.v, np.float64),
        "rows": np.asarray(inst.rows, np.int32),
        "cols": np.asarray(inst.cols, np.int32),
        "opt_cost": float(inst.cost[inst.rows, inst.cols].sum()),
        "n": int(inst.size),
        "family": inst.family,
    }
