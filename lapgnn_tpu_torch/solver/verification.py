"""Float64 optimality certificate (port of
``lapgnn_tpu/solver/verification.py:certify_assignment`` :18)."""

from __future__ import annotations

import numpy as np

__all__ = ["certify_assignment"]


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
