"""Plain reference of the assignment problem: the float64 optimum of each
instance, the float64 cost of any assignment, and a set of optimal duals.

Independent of the program: SciPy's ``linear_sum_assignment`` (the shortest
augmenting path solver of Crouse, 2016) gives the optimum, NumPy the costs,
and a Bellman-Ford pass over the optimum's residual graph (plain PyTorch,
float64) the duals.  Imports nothing of the program or of JAX.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

__all__ = ["assignment_cost", "is_permutation", "optimal_duals", "optima"]


def assignment_cost(C: np.ndarray, x: np.ndarray) -> float:
    """Float64 cost of the assignment row i -> column x[i]."""
    n = C.shape[0]
    return float(np.asarray(C, np.float64)[np.arange(n), x].sum())


def is_permutation(x: np.ndarray, n: int) -> bool:
    x = np.asarray(x)
    return x.shape == (n,) and bool(np.array_equal(np.sort(x), np.arange(n)))


def _optimum(C: np.ndarray) -> Tuple[float, np.ndarray]:
    C64 = np.asarray(C, np.float64)
    _, cols = linear_sum_assignment(C64)
    return assignment_cost(C64, cols), cols


def optima(pool: Sequence[np.ndarray], workers: int = 8) -> List[Tuple[float, np.ndarray]]:
    """(optimal float64 cost, an optimal assignment) of each matrix; SciPy
    releases the interpreter lock, so the solves run on ``workers`` threads."""
    with ThreadPoolExecutor(max_workers=max(1, min(workers, len(pool)))) as ex:
        return list(ex.map(_optimum, pool))


def optimal_duals(C: np.ndarray, x: np.ndarray, device: torch.device) -> np.ndarray:
    """Row duals u of the optimal assignment x (complementary slackness), for
    one matrix (n, n) or a stack (B, n, n) with its assignments (B, n):
    column potentials v are the shortest distances in the graph with an arc
    x[i] -> j of length C[i, j] - C[i, x[i]] (Bellman-Ford from a source at
    distance 0 to every column, all matrices of a stack at once), and
    u_i = C[i, x[i]] - v[x[i]].  Then C[i, j] - u_i - v_j >= 0 everywhere,
    with equality on x.  Float64."""
    Ct = torch.as_tensor(np.asarray(C, np.float64), device=device)
    xt = torch.as_tensor(np.asarray(x, np.int64), device=device)
    single = Ct.ndim == 2
    if single:
        Ct, xt = Ct[None], xt[None]
    n = Ct.shape[-1]
    on_x = torch.gather(Ct, 2, xt[..., None])[..., 0]
    arc = Ct - on_x[..., None]  # arc[b, i, j]: from column x[b, i] to column j
    v = torch.zeros(Ct.shape[:2], dtype=torch.float64, device=device)
    for r in range(n + 1):
        new = torch.minimum(v, (torch.gather(v, 1, xt)[..., None] + arc).amin(1))
        if r % 8 == 7 and torch.equal(new, v):
            break
        v = new
    else:
        raise ArithmeticError("the assignment is not optimal: a negative cycle remains")
    u = (on_x - torch.gather(v, 1, xt)).cpu().numpy()
    return u[0] if single else u
