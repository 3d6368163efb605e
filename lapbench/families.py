"""The cost-matrix families the benchmark's traffic draws from (NumPy only).

A frozen copy of the seven distinct families of the port's dataset registry
(``lapgnn_tpu_torch/data/generators.py:191-249``, ``FAMILIES``, without its
alias ``clustered``), with the closed forms they call
(``generate_uniform_costs`` :48, ``_repair_feasibility`` :81,
``generate_metric_costs`` :93, ``generate_clustered_costs`` :105,
``generate_noisy_linear_costs`` :120).  The benchmark keeps its own copy so that a
change to the program's generators cannot change the traffic it is measured
on.  Each family is ``fn(n, rng) -> (n, n) float64``, drawn from an explicit
``numpy.random.Generator``.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

__all__ = ["FAMILIES", "draw"]

DATASET_SPARSE_FORBIDDEN = 1.0e6


def _seed_from(rng: np.random.Generator) -> int:
    return int(rng.integers(0, np.iinfo(np.uint32).max))


def _uniform(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0.0, 1.0, (n, n)).astype(np.float64)


def _repair_feasibility(keep: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Force >= 1 allowed edge per row and per column."""
    n = keep.shape[0]
    empty_rows = ~keep.any(axis=1)
    if empty_rows.any():
        keep[empty_rows, rng.integers(0, n, size=int(empty_rows.sum()))] = True
    empty_cols = ~keep.any(axis=0)
    if empty_cols.any():
        keep[rng.integers(0, n, size=int(empty_cols.sum())), empty_cols] = True
    return keep


def _fam_uniform(n: int, rng: np.random.Generator) -> np.ndarray:
    return _uniform(n, _seed_from(rng))


def _fam_metric(n: int, rng: np.random.Generator) -> np.ndarray:
    """Euclidean distances between random 2-D points in [0, 100]^2."""
    pts = np.random.default_rng(_seed_from(rng)).uniform(0.0, 100.0, (n, 2))
    sq = np.einsum("ij,ij->i", pts, pts)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (pts @ pts.T)
    np.maximum(d2, 0.0, out=d2)
    np.fill_diagonal(d2, 0.0)
    return np.sqrt(d2, out=d2)


def _fam_low_rank(n: int, rng: np.random.Generator, rank: int = 12, sigma: float = 0.1) -> np.ndarray:
    """Rank-12 bilinear + noise, clipped non-negative."""
    a = rng.normal(0.0, 1.0, size=(n, rank))
    b = rng.normal(0.0, 1.0, size=(n, rank))
    return np.maximum(a @ b.T + sigma * rng.normal(0.0, 1.0, size=(n, n)), 0.0).astype(np.float64)


def _fam_block(n: int, rng: np.random.Generator, blocks: int = 4, noise: float = 0.1) -> np.ndarray:
    """Block-diagonal discount structure."""
    r = np.random.default_rng(_seed_from(rng))
    C = r.uniform(0.0, 1.0, (n, n))
    bs = max(1, n // max(1, blocks))
    for b in range(blocks):
        i0 = b * bs
        i1 = n if b == blocks - 1 else min(n, (b + 1) * bs)
        C[i0:i1, i0:i1] -= 0.4
    C += noise * r.normal(0.0, 1.0, (n, n))
    return np.maximum(C, 0.0).astype(np.float64)


def _fam_noisy_linear(n: int, rng: np.random.Generator, rank: int = 1, noise: float = 0.1) -> np.ndarray:
    """Low-rank outer product + Gaussian noise, shifted non-negative."""
    r = np.random.default_rng(_seed_from(rng))
    base = r.normal(size=(n, rank)) @ r.normal(size=(rank, n))
    C = base + r.normal(scale=noise, size=(n, n))
    C -= C.min()
    return C.astype(np.float64)


def _fam_tie(n: int, rng: np.random.Generator, bins: int = 5, jitter: float = 1e-6) -> np.ndarray:
    """Tie-heavy: binned costs + microscopic jitter."""
    base = rng.integers(0, max(1, bins), size=(n, n)) / max(1, float(bins))
    return (base + jitter * rng.uniform(0.0, 1.0, size=(n, n))).astype(np.float64)


def _fam_sparse(n: int, rng: np.random.Generator, sparsity: float = 0.3) -> np.ndarray:
    """Dataset-style sparse: forbidden edges at 1e6."""
    C = _uniform(n, _seed_from(rng))
    keep = rng.random(size=(n, n)) < sparsity
    keep = _repair_feasibility(keep, rng)
    C[~keep] = DATASET_SPARSE_FORBIDDEN
    return C.astype(np.float64)


FAMILIES: Dict[str, Callable[[int, np.random.Generator], np.ndarray]] = {
    "uniform": _fam_uniform,
    "metric": _fam_metric,
    "low_rank": _fam_low_rank,
    "block": _fam_block,
    "noisy_linear": _fam_noisy_linear,
    "tie": _fam_tie,
    "sparse": _fam_sparse,
}


def draw(families, n: int, seed: int, dtype=np.float32):
    """A pool of instances from ``families`` (one family name an instance,
    in that order), each from its own stream of ``seed``: instance i of a
    pool is the same whatever the pool's other families.  Returns a list of
    (family, (n, n) array of ``dtype``)."""
    pool = []
    for i, fam in enumerate(families):
        rng = np.random.default_rng([int(seed), i])
        pool.append((fam, FAMILIES[fam](n, rng).astype(dtype)))
    return pool
