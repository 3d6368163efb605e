"""Non-learned warm-start seeds (port of ``lapgnn_tpu/solver/seed_baselines.py``).

Cheap feasible (u, v) seeds that need no GNN: benchmark baselines, and the
seed source of ``cli.benchmark --seed-baseline`` when no checkpoint is
given.  NumPy on the host, built on ``ops.host_dual``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..ops.host_dual import (
    duals_from_matching_np,
    make_feasible_duals_np,
    project_feasible_np,
)

__all__ = [
    "seed_row_col_minima",
    "seed_greedy_matching",
    "seed_noisy_optimal",
    "seed_rank1_analytic",
]


def seed_row_col_minima(
    C: np.ndarray, project_rounds: int = 50
) -> Tuple[np.ndarray, np.ndarray]:
    """Row minima for u, residual column minima for v, then project."""
    C = np.asarray(C, dtype=np.float64)
    u = C.min(axis=1).copy()
    v = (C - u[:, None]).min(axis=0)
    return project_feasible_np(C, u, v, max_rounds=project_rounds)


def seed_greedy_matching(
    C: np.ndarray,
    project_rounds: int = 50,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy row-by-row matching -> difference-constraint duals -> project.
    Each row in order takes the cheapest still-free column; the resulting
    (suboptimal) matching seeds the dual reconstruction, whose
    infeasibilities are then projected away."""
    C = np.asarray(C, dtype=np.float64)
    n = C.shape[0]
    rng = rng or np.random.default_rng()

    free = np.ones(n, dtype=bool)
    cols = np.empty(n, dtype=np.int64)
    for i in range(n):
        masked = np.where(free, C[i], np.inf)
        j = int(np.argmin(masked))
        cols[i] = j
        free[j] = False

    try:
        u, v, _ = duals_from_matching_np(C, np.arange(n), cols)
    except (AssertionError, RuntimeError):
        # a suboptimal matching usually violates complementary slackness:
        # project the raw tight-edge potentials instead
        v = np.zeros(n)
        u = C[np.arange(n), cols] - v[cols]
    return project_feasible_np(C, u, v, max_rounds=project_rounds)


def seed_noisy_optimal(
    C: np.ndarray,
    noise_std: float = 0.05,
    rng: Optional[np.random.Generator] = None,
    project_rounds: int = 75,
) -> Tuple[np.ndarray, np.ndarray]:
    """Oracle duals with Gaussian noise, projected back to feasibility."""
    rng = rng or np.random.default_rng()
    u_opt, v_opt = make_feasible_duals_np(np.asarray(C, np.float64))
    u = u_opt + rng.normal(0.0, noise_std, size=u_opt.shape)
    v = v_opt + rng.normal(0.0, noise_std, size=v_opt.shape)
    return project_feasible_np(np.asarray(C, np.float64), u, v, max_rounds=project_rounds)


def seed_rank1_analytic(
    C: np.ndarray, iters: int = 6, project_rounds: int = 50
) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form Monge duals of the rank-1 (+ constant) fit: the NumPy host
    twin of ``ops/rank1.py``.  Near-oracle on the rank-1-dominant families
    (noisy_linear, low_rank), where row / column minima are weakest."""
    C = np.asarray(C, dtype=np.float64)
    n = C.shape[0]
    delta = C.mean()
    R = C - delta
    x = np.full(n, 1.0 / np.sqrt(n))
    for _ in range(iters):
        y = R @ x
        y /= max(np.linalg.norm(y), 1e-30)
        x = R.T @ y
        x /= max(np.linalg.norm(x), 1e-30)
    y = R @ x
    y /= max(np.linalg.norm(y), 1e-30)
    a = y * float(y @ R @ x)
    b = x
    pi = np.argsort(a)
    qi = np.argsort(-b)
    As, Bs = a[pi], b[qi]
    u_s = np.concatenate([[0.0], np.cumsum(np.diff(As) * Bs[1:])])
    v_s = As * Bs - u_s
    u = np.empty(n)
    v = np.empty(n)
    u[pi] = u_s + delta
    v[qi] = v_s
    return project_feasible_np(C, u, v, max_rounds=project_rounds)
