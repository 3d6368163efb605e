"""Host-side (NumPy, float64) dual oracle: labels for synthetic instances.

The port's own copy of ``lapgnn_tpu/ops/host_dual.py`` (numpy and SciPy
only, so the port needs nothing of the JAX package):

  * ``project_feasible_np``: alternating min-cap projection to feasibility;
  * ``duals_from_matching_np``: optimal duals from an optimal matching by
    difference constraints, relaxed as a min-plus fixpoint
    ``v <- min(v, min_i(C[i, :] - (C[i, p_i] - v[p_i])))``;
  * ``oracle_duals_np``: optimal duals with optional Gaussian noise;
  * ``make_feasible_duals_np``: solve, reconstruct, add noise, project;
  * ``check_dual_feasible_np`` / ``check_dual_and_match_np``: raising checks;
  * ``reduce_costs_np`` and ``normalize01_np``;
  * ``affine_invariance_check``: a solver self-test, cost(aC + b) against
    a·cost(C) + b·n;
  * ``print_env_summary``: the thread and seed settings and the library
    versions.  Where the JAX module reads ``JAX_PLATFORMS`` this one reads
    the variables that place the port's work, ``CUDA_VISIBLE_DEVICES`` and
    ``PYTORCH_CUDA_ALLOC_CONF``, as ``bench.logging_system`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.optimize

__all__ = [
    "project_feasible_np",
    "duals_from_matching_np",
    "oracle_duals_np",
    "make_feasible_duals_np",
    "check_dual_feasible_np",
    "check_dual_and_match_np",
    "reduce_costs_np",
    "normalize01_np",
    "affine_invariance_check",
    "print_env_summary",
]


def project_feasible_np(
    C: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    max_rounds: int = 50,
    tol: float = 1e-12,
) -> Tuple[np.ndarray, np.ndarray]:
    """Alternating min-cap projection until feasible."""
    C = np.asarray(C, dtype=float)
    u = np.asarray(u, dtype=float).copy()
    v = np.asarray(v, dtype=float).copy()
    for _ in range(max(1, int(max_rounds))):
        u = np.minimum(u, (C - v[None, :]).min(axis=1))
        v = np.minimum(v, (C - u[:, None]).min(axis=0))
        if (C - u[:, None] - v[None, :]).min() >= -tol:
            break
    return u, v


def duals_from_matching_np(
    C: np.ndarray,
    row_ind: np.ndarray,
    col_ind: np.ndarray,
    tol: float = 1e-12,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Optimal duals from an optimal matching via difference constraints.

    Returns (u, v, reduced).  Raises AssertionError if the reconstruction is
    infeasible or violates complementary slackness.
    """
    C = np.asarray(C, dtype=float)
    m, n = C.shape
    col_of_row = np.full(m, -1, dtype=np.int64)
    col_of_row[np.asarray(row_ind)] = np.asarray(col_ind)
    matched = col_of_row >= 0

    c_match = np.where(matched, C[np.arange(m), np.where(matched, col_of_row, 0)], 0.0)
    v = np.zeros(n, dtype=float)
    for _ in range(n):
        t = c_match - v[np.where(matched, col_of_row, 0)]
        cand = np.where(matched[:, None], C - t[:, None], np.inf).min(axis=0)
        v_new = np.minimum(v, cand)
        if np.all(v_new >= v - tol):
            v = v_new
            break
        v = v_new

    u = np.empty(m, dtype=float)
    u[matched] = c_match[matched] - v[col_of_row[matched]]
    if (~matched).any():
        u[~matched] = (C[~matched] - v[None, :]).min(axis=1)

    # Gauge fix: split the mean shift between u and v.
    shift = (u.mean() + v.mean()) / 2.0
    u -= shift
    v += shift

    red = C - u[:, None] - v[None, :]
    if red.min() < -1e-8:
        raise AssertionError("Dual infeasible after reconstruction")
    if np.abs(red[np.asarray(row_ind), np.asarray(col_ind)]).max() > 1e-6:
        raise AssertionError("Complementary slackness violated on matched edge")
    return u, v, red


def oracle_duals_np(
    C: np.ndarray, noise_level: float = 0.0, noise_seed: int = 42
) -> Tuple[np.ndarray, np.ndarray]:
    """Optimal duals with optional Gaussian noise."""
    n = C.shape[0]
    rows, cols = scipy.optimize.linear_sum_assignment(C)
    try:
        u, v, _ = duals_from_matching_np(C, rows, cols)
    except (RuntimeError, AssertionError):
        # Reconstruction failed (threshold trip on large-magnitude costs):
        # the raw tight-edge potentials are generally dual-INFEASIBLE, and
        # callers treat this function's output as optimal duals (dataset
        # labels, oracle-seed benchmarks) — project to feasibility instead
        # of returning them unchecked.
        import warnings

        warnings.warn(
            "oracle_duals_np: dual reconstruction failed; returning "
            "projected (feasible but possibly non-optimal) duals",
            RuntimeWarning,
            stacklevel=2,
        )
        u = np.zeros(n, dtype=np.float64)
        v = np.min(C, axis=0)
        u[rows] = C[rows, cols] - v[cols]
        u, v = project_feasible_np(C, u, v)
    if noise_level > 0:
        rng = np.random.default_rng(noise_seed)
        u = u + rng.normal(0.0, noise_level, n)
        v = v + rng.normal(0.0, noise_level, n)
    return u.astype(np.float64), v.astype(np.float64)


def make_feasible_duals_np(
    C: np.ndarray,
    iters: int = 2,
    noise_std: float = 0.0,
    project_rounds: int = 10,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Solve -> reconstruct -> (noise) -> project."""
    C = np.asarray(C, dtype=float)
    rows, cols = scipy.optimize.linear_sum_assignment(C)
    u, v, _ = duals_from_matching_np(C, rows, cols)
    if noise_std and noise_std > 0:
        rng = rng or np.random.default_rng(0)
        u = u + rng.normal(0.0, noise_std, size=u.shape)
        v = v + rng.normal(0.0, noise_std, size=v.shape)
    # Honest knob: an explicit project_rounds/iters is respected (the old
    # max(10, rounds) silently overrode anything below 10); the early
    # feasibility break inside project_feasible_np keeps small values safe.
    rounds = max(int(project_rounds), int(iters or 0), 1)
    return project_feasible_np(C, u, v, max_rounds=rounds, tol=1e-12)


def check_dual_feasible_np(C, u, v, tol: float = 1e-8) -> bool:
    mn = float((C - u[:, None] - v[None, :]).min())
    if mn < -tol:
        raise AssertionError(f"Dual infeasible: min reduced cost {mn:.3e} < -{tol}")
    return True


def check_dual_and_match_np(C, u, v, rows, cols, tol: float = 1e-8) -> bool:
    red = C - u[:, None] - v[None, :]
    if not np.all(red >= -tol):
        raise AssertionError("Dual infeasible")
    if not np.all(np.abs(red[rows, cols]) <= 1e-6):
        raise AssertionError("CS violated on matched edges")
    return True


def reduce_costs_np(C, u, v, shift_nonneg: bool = True) -> np.ndarray:
    """C' = C - u - v, optionally shifted non-negative."""
    Cp = np.asarray(C, dtype=float) - u[:, None] - v[None, :]
    if shift_nonneg:
        m = Cp.min()
        if m < 0:
            Cp = Cp - m
    return np.ascontiguousarray(Cp, dtype=np.float64)


def normalize01_np(C: np.ndarray) -> np.ndarray:
    """Scale costs to [0, 1]."""
    C = np.ascontiguousarray(C, dtype=np.float64)
    mn, mx = float(C.min()), float(C.max())
    return (C - mn) / ((mx - mn) if mx > mn else 1.0)


def affine_invariance_check(solve_fn, n: int = 64, trials: int = 3, seed: int = 0) -> bool:
    """Whether cost(aC + b) == a·cost(C) + b·n over ``trials`` random affine
    maps of random (n, n) matrices; ``solve_fn(C) -> (rows, cols, cost)``."""
    rng = np.random.default_rng(seed)
    ok = True
    for _ in range(trials):
        C = rng.uniform(0.0, 1.0, (n, n))
        _, _, cost = solve_fn(C)
        a = 10.0 ** rng.uniform(-2, 2)
        b = float(rng.uniform(-3.0, 3.0))
        _, _, cost2 = solve_fn(a * C + b)
        if not np.isclose(cost2, a * cost + b * n, rtol=1e-9, atol=1e-9):
            ok = False
    return ok


ENV_VARIABLES = (
    "OMP_NUM_THREADS",
    "MKL_NUM_THREADS",
    "OPENBLAS_NUM_THREADS",
    "NUMEXPR_NUM_THREADS",
    "CUDA_VISIBLE_DEVICES",
    "PYTORCH_CUDA_ALLOC_CONF",
    "PYTHONHASHSEED",
)


def print_env_summary() -> dict:
    """Print and return the environment's settings that change a run: the
    variables of ``ENV_VARIABLES`` and the Python, numpy and SciPy
    versions."""
    import os
    import platform

    info = {
        "env": {k: os.environ.get(k) for k in ENV_VARIABLES},
        "python": platform.python_version(),
        "numpy": np.__version__,
        "scipy": scipy.__version__,
    }
    print(f"[env] {info}")
    return info
