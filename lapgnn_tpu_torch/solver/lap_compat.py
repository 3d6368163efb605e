"""Drop-in compatibility API of the ``lap`` package on the native backend.

The port's copy of ``lapgnn_tpu/solver/lap_compat.py``:

  * ``lapjv(cost, extend_cost=False, cost_limit=inf, return_cost=True)``
    with non-square extension (zero padding to max(n, m)) and the cost-limit
    doubling (an (n_rows + n_cols)^2 matrix filled with cost_limit / 2 and a
    zero bottom-right block); unmatched rows and columns are reported as -1.
  * ``lapmod(n, cc, ii, kk)``: the CSR sparse solve.
  * ``lapjv_seeded(cost, u, v, eps)``: the warm-started solve.
  * ``LARGE`` and the ``FP_*`` constants; ``fp_version`` selects the
    find-path strategy: FP_1 dense scans, FP_2 a frontier list, FP_DYNAMIC
    either at the 25% density threshold.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["lapjv", "lapmod", "lapjv_seeded", "LARGE", "FP_1", "FP_2", "FP_DYNAMIC"]

# Sentinel cost of a forbidden sparse entry.
LARGE = 1000000

# Find-path strategy flags.
FP_1 = 1
FP_2 = 2
FP_DYNAMIC = 3


def lapjv(
    cost: np.ndarray,
    extend_cost: bool = False,
    cost_limit: float = np.inf,
    return_cost: bool = True,
):
    """Solve a dense LAP with the ``lap.lapjv`` call signature.

    Returns (opt, x, y) (or (x, y) when ``return_cost`` is False); x maps
    rows to columns, y columns to rows, -1 marks unmatched entries under
    ``extend_cost`` / ``cost_limit``.
    """
    from .native import lapjv_native

    C = np.ascontiguousarray(cost, dtype=np.float64)
    if C.ndim != 2:
        raise ValueError("2-dimensional array expected")
    n_rows, n_cols = C.shape
    if n_rows != n_cols and not extend_cost:
        # any non-square input without extend_cost raises, cost_limit or not:
        # a finite cost_limit must not paper over a caller's shape bug
        raise ValueError(
            "Square cost array expected. If cost is intentionally non-square, "
            "pass extend_cost=True."
        )

    if np.isfinite(cost_limit):
        n = n_rows + n_cols
        Ce = np.full((n, n), cost_limit / 2.0, dtype=np.float64)
        Ce[n_rows:, n_cols:] = 0.0
        Ce[:n_rows, :n_cols] = C
    elif n_rows != n_cols:
        n = max(n_rows, n_cols)
        Ce = np.zeros((n, n), dtype=np.float64)
        Ce[:n_rows, :n_cols] = C
    else:
        Ce = C

    x, y, _ = lapjv_native(Ce)
    x = np.asarray(x, np.int32)
    y = np.asarray(y, np.int32)

    if np.isfinite(cost_limit) or n_rows != n_cols:
        x = x.copy()
        y = y.copy()
        x[x >= n_cols] = -1
        y[y >= n_rows] = -1
        x = x[:n_rows]
        y = y[:n_cols]
        opt = float(C[np.nonzero(x != -1)[0], x[x != -1]].sum())
    else:
        opt = float(C[np.arange(n_rows), x].sum())

    if return_cost:
        return opt, x, y
    return x, y


def lapmod(
    n: int,
    cc: np.ndarray,
    ii: np.ndarray,
    kk: np.ndarray,
    fast: bool = True,
    return_cost: bool = True,
    fp_version: int = FP_DYNAMIC,
):
    """Sparse CSR solve with the ``lap.lapmod`` call signature.

    ``cc``: flattened costs, ``ii``: row pointers (n + 1), ``kk``: column
    indices.  Costs must be non-negative and below ``LARGE``.
    """
    from .native import lapmod_native

    cc = np.ascontiguousarray(cc, np.float64)
    ii = np.ascontiguousarray(ii, np.int64)
    kk = np.ascontiguousarray(kk, np.int64)
    if n <= 0:
        raise ValueError("n must be positive")
    if ii.shape[0] != n + 1:
        raise ValueError("ii must have n+1 entries")
    if kk.shape[0] == 0 or int(ii[-1]) == 0:
        raise ValueError("empty sparse cost (no allowed edges)")
    if np.any(cc < 0):
        raise ValueError("negative costs are not supported")
    if np.any(cc >= LARGE):
        raise ValueError(f"costs must be below LARGE={LARGE}")

    x, y, cost = lapmod_native(int(n), ii, kk, cc, fp_version=int(fp_version))
    if return_cost:
        return cost, np.asarray(x, np.int32), np.asarray(y, np.int32)
    return np.asarray(x, np.int32), np.asarray(y, np.int32)


def lapjv_seeded(
    cost: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    eps: float = 1e-12,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Warm-started solve with the ``lap.lapjv_seeded`` signature.  Returns
    (x, y, cost).  The native projection always reaches feasibility, so no
    seed is rejected.  A rectangular cost is zero-padded to square (dummy
    rows and columns cost 0, seeds padded with zeros): the square optimum
    restricted to the real rows is the rectangular one."""
    from .native import lapjv_seeded_native

    C = np.ascontiguousarray(cost, dtype=np.float64)
    if C.ndim != 2:
        raise ValueError("2-dimensional cost matrix expected")
    n_rows, n_cols = C.shape
    u = np.ascontiguousarray(u, np.float64)
    v = np.ascontiguousarray(v, np.float64)
    if u.shape[0] != n_rows or v.shape[0] != n_cols:
        raise ValueError("seed lengths must match the cost shape")
    if n_rows == n_cols:
        x, y, total = lapjv_seeded_native(C, u, v, eps=eps)
        return np.asarray(x, np.int32), np.asarray(y, np.int32), float(total)
    m = max(n_rows, n_cols)
    Ce = np.zeros((m, m), np.float64)
    Ce[:n_rows, :n_cols] = C
    ue = np.zeros(m, np.float64)
    ue[:n_rows] = u
    ve = np.zeros(m, np.float64)
    ve[:n_cols] = v
    xe, ye, _ = lapjv_seeded_native(Ce, ue, ve, eps=eps)
    x = xe[:n_rows].astype(np.int32)
    x[x >= n_cols] = -1
    y = ye[:n_cols].astype(np.int32)
    y[y >= n_rows] = -1
    mask = x >= 0
    total = float(C[np.nonzero(mask)[0], x[mask]].sum())
    return x, y, total
