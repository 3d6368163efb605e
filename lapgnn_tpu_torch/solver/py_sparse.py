"""Pure-NumPy sparse Jonker–Volgenant solver, the readable executable spec.

The port's copy of ``lapgnn_tpu/solver/py_sparse.py``: a slow but
transparent third implementation beside the native CSR solver
(``solver.native.lapmod_native``), used in tests to cross-check it.  CSR
input (row_ptr of n + 1 entries, col_idx, values); absent entries are
forbidden edges.  Returns (col_of_row, row_of_col, cost) or raises
ValueError when no perfect matching exists on the allowed edges.

Algorithm: sparse column reduction, then one Dijkstra shortest augmenting
path per remaining free row with the classical settled-set dual update, the
invariant structure of ``solver/native/lapx.cpp``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["lapmod_py", "check_cost"]


def check_cost(values: np.ndarray, large: float = 1e6) -> None:
    """Costs must be non-negative and below ``large`` (the LAPMOD contract)."""
    values = np.asarray(values)
    if values.size and values.min() < 0:
        raise ValueError("negative costs are not supported")
    if values.size and values.max() >= large:
        raise ValueError(f"costs must be below {large}")


def lapmod_py(
    n: int,
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, float]:
    row_ptr = np.asarray(row_ptr, np.int64)
    col_idx = np.asarray(col_idx, np.int64)
    values = np.asarray(values, np.float64)
    if row_ptr.shape[0] != n + 1:
        raise ValueError("row_ptr must have n+1 entries")
    check_cost(values)

    x = np.full(n, -1, np.int64)
    y = np.full(n, -1, np.int64)
    v = np.full(n, np.inf)
    best_row = np.full(n, -1, np.int64)

    # Sparse column reduction.
    for i in range(n):
        seg = slice(row_ptr[i], row_ptr[i + 1])
        for j, c in zip(col_idx[seg], values[seg]):
            if c < v[j]:
                v[j] = c
                best_row[j] = i
    for j in range(n - 1, -1, -1):
        i = best_row[j]
        if i >= 0 and x[i] < 0:
            x[i] = j
            y[j] = i
    v[np.isinf(v)] = 0.0

    # Dijkstra augmenting path per free row.
    for f in np.nonzero(x < 0)[0]:
        d = np.full(n, np.inf)
        pred = np.full(n, f, np.int64)
        settled = np.zeros(n, bool)
        seg = slice(row_ptr[f], row_ptr[f + 1])
        d[col_idx[seg]] = values[seg] - v[col_idx[seg]]

        sink, sink_dist = -1, 0.0
        for _ in range(n + 1):
            open_d = np.where(settled, np.inf, d)
            j = int(np.argmin(open_d))
            if not np.isfinite(open_d[j]):
                raise ValueError("no perfect matching on allowed edges")
            owner = y[j]
            if owner < 0:
                sink, sink_dist = j, open_d[j]
                break
            settled[j] = True
            seg = slice(row_ptr[owner], row_ptr[owner + 1])
            cols = col_idx[seg]
            # Owner's slack at its matched column j.
            at_j = cols == j
            base = open_d[j] - (values[seg][at_j][0] - v[j])
            cand = base + values[seg] - v[cols]
            better = ~settled[cols] & (cand < d[cols])
            d[cols[better]] = cand[better]
            pred[cols[better]] = owner
        if sink < 0:
            raise ValueError("no perfect matching on allowed edges")

        v[settled] += d[settled] - sink_dist
        j = sink
        while True:
            i = pred[j]
            y[j] = i
            x[i], j = j, x[i]
            if i == f:
                break

    cost = 0.0
    for i in range(n):
        seg = slice(row_ptr[i], row_ptr[i + 1])
        cost += float(values[seg][col_idx[seg] == x[i]][0])
    return x, y, cost
