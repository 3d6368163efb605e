"""Float64 optimality certificate and the cross-solver agreement gate (port
of ``lapgnn_tpu/solver/verification.py``).

Every solver must return a valid permutation at the same cost (within a
tolerance) before any timing is trusted: ``cli.main_benchmark`` runs the
gate before each group it times.
"""

from __future__ import annotations

import inspect
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["verify_solver_correctness", "certify_assignment"]


def certify_assignment(C: np.ndarray, col_of_row: np.ndarray, v: np.ndarray, tol: float = 1e-6):
    """With u_i = C[i, x_i] - v[x_i], (u, v) is tight on the assignment; if
    min_ij (C - u - v) >= -tol, LP duality bounds the suboptimality by
    n * tol.  A non-bijective assignment or a non-finite reduced cost fails.

    Returns (certified: bool, max_violation: float, gap_bound: float)."""
    C = np.asarray(C, np.float64)
    n = C.shape[-1]
    x = np.asarray(col_of_row)
    v = np.asarray(v, np.float64)
    if not _is_permutation(x, n):
        return False, float("inf"), float("inf")
    u = C[np.arange(n), x] - v[x]
    min_red = float((C - u[:, None] - v[None, :]).min())
    if not np.isfinite(min_red):
        return False, float("inf"), float("inf")
    violation = max(0.0, -min_red)
    return violation <= tol, violation, n * violation


def _is_permutation(cols: np.ndarray, n: int) -> bool:
    cols = np.asarray(cols)
    return len(cols) == n and np.array_equal(np.sort(cols), np.arange(n))


def _accepts_seed(solve_fn) -> bool:
    """Whether a solver's ``solve`` takes (u, v) keywords, decided by its
    signature, not by catching a TypeError from the call: a TypeError raised
    inside a seeded solver would otherwise retry it unseeded and hide the
    fault."""
    try:
        params = inspect.signature(solve_fn).parameters
    except (TypeError, ValueError):
        return False
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return True
    return "u" in params and "v" in params


def verify_solver_correctness(
    C: np.ndarray,
    solvers: Optional[Sequence] = None,
    tol: float = 1e-10,
    u: Optional[np.ndarray] = None,
    v: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Solve ``C`` with every solver and raise unless all costs agree within
    ``tol`` (relative to max(1, |cost|)).  Seeded solvers receive (u, v) if
    given (zeros otherwise: a zero seed must still be exactly optimal).
    Returns {solver_name: cost}.

    The comparisons are NaN-hostile (``not (x <= tol)`` rather than
    ``x > tol``): a NaN cost, or a NaN in ``C`` that makes the recomputed
    cost NaN, fails the gate."""
    from .api import LAPSolver, SciPySolver, SeededLAPSolver

    if solvers is None:
        solvers = [SciPySolver(), LAPSolver(), SeededLAPSolver()]

    n = C.shape[0]
    costs: Dict[str, float] = {}
    ref: Optional[float] = None
    for s in solvers:
        if _accepts_seed(s.solve):
            rows, cols, cost = s.solve(C, u=u, v=v)
        else:
            rows, cols, cost = s.solve(C)
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        if not _is_permutation(cols, n) or not _is_permutation(rows, n):
            raise AssertionError(f"{s.name}: result is not a permutation")
        recomputed = float(np.asarray(C)[rows, cols].sum())
        if not (abs(recomputed - cost) <= tol * max(1.0, abs(recomputed))):
            raise AssertionError(
                f"{s.name}: reported cost {cost} != recomputed {recomputed}"
            )
        if ref is None:
            ref = float(cost)
        # against the first solver, not a name-keyed dict after the loop: two
        # solvers of one name would overwrite each other and escape the check
        if not (abs(float(cost) - ref) <= tol * max(1.0, abs(ref))):
            raise AssertionError(
                f"solver disagreement: {s.name}={cost} vs reference={ref}"
            )
        costs[s.name] = float(cost)
    return costs
