"""Cost-matrix family generators (numpy only).

The port's own copy of ``lapgnn_tpu/data/generators.py``, so the port draws
the same instances without the JAX package:

  * ``generate_<family>(n, seed=...)``: host NumPy, float64;
  * ``generate_planted_optimum_instance``: a matrix with a known optimum;
  * ``FAMILIES``: name -> callable(n, rng) with an explicit numpy Generator,
    the registry of the synthetic datasets.

Every family is a closed-form NumPy expression.  The JAX module's
``jax_uniform_costs`` (a device-side batch drawn from a JAX key) is not
copied: its counterpart would draw from a ``torch.Generator``, whose numbers
differ from JAX's.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

__all__ = [
    "generate_uniform_costs",
    "generate_near_diagonal_costs",
    "generate_sparse_costs",
    "generate_metric_costs",
    "generate_clustered_costs",
    "generate_noisy_linear_costs",
    "generate_worst_case_costs",
    "generate_identity_like_costs",
    "generate_hard_random_costs",
    "generate_planted_optimum_instance",
    "FAMILIES",
    "SYNTHETIC_FAMILIES",
]

# Sentinel cost for forbidden edges in the "sparse" benchmark family
# (the benchmark family uses 100.0, the dataset family 1e6).
SPARSE_FORBIDDEN = 100.0
DATASET_SPARSE_FORBIDDEN = 1.0e6


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def generate_uniform_costs(n: int, seed: int = 42) -> np.ndarray:
    """Uniform[0, 1] costs."""
    return _rng(seed).uniform(0.0, 1.0, (n, n)).astype(np.float64)


def generate_near_diagonal_costs(
    n: int, noise_level: float = 0.1, seed: int = 42
) -> np.ndarray:
    """Diagonal-preference + Gaussian noise.

    C[i, j] = 0.1 + 0.9 |i - j| / n + N(0, noise), clipped below at 1e-3.
    """
    rng = _rng(seed)
    idx = np.arange(n, dtype=np.float64)
    base = 0.1 + 0.9 * np.abs(idx[:, None] - idx[None, :]) / n
    C = base + rng.normal(0.0, noise_level, (n, n))
    return np.maximum(C, 0.001).astype(np.float64)


def generate_sparse_costs(
    n: int, sparsity_ratio: float = 0.3, seed: int = 42
) -> np.ndarray:
    """Sparse instance: ~sparsity_ratio of edges kept, rest set to 100.0.
    Each row and column is guaranteed at least one allowed edge so the
    instance stays feasible.
    """
    rng = _rng(seed)
    C = rng.uniform(0.1, 1.0, (n, n))
    keep = rng.random((n, n)) < sparsity_ratio
    keep = _repair_feasibility(keep, rng)
    return np.where(keep, C, SPARSE_FORBIDDEN).astype(np.float64)


def _repair_feasibility(keep: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Force >=1 allowed edge per row and per column."""
    n = keep.shape[0]
    empty_rows = ~keep.any(axis=1)
    if empty_rows.any():
        keep[empty_rows, rng.integers(0, n, size=int(empty_rows.sum()))] = True
    empty_cols = ~keep.any(axis=0)
    if empty_cols.any():
        keep[rng.integers(0, n, size=int(empty_cols.sum())), empty_cols] = True
    return keep


def generate_metric_costs(n: int, seed: int = 42) -> np.ndarray:
    """Euclidean distances between random 2-D points in [0, 100]^2."""
    pts = _rng(seed).uniform(0.0, 100.0, (n, 2))
    # Gram form, not an (n, n, 2) broadcast difference: the naive version
    # peaks at ~5x the result's memory (10+ GB at n=16K for a 2 GB matrix).
    sq = np.einsum("ij,ij->i", pts, pts)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (pts @ pts.T)
    np.maximum(d2, 0.0, out=d2)  # rounding can leave tiny negatives
    np.fill_diagonal(d2, 0.0)    # exactly zero self-distance (Gram residue)
    return np.sqrt(d2, out=d2)


def generate_clustered_costs(
    n: int, blocks: int = 4, noise: float = 0.1, seed: int = 42
) -> np.ndarray:
    """Block-diagonal discount structure."""
    rng = _rng(seed)
    C = rng.uniform(0.0, 1.0, (n, n))
    bs = max(1, n // max(1, blocks))
    for b in range(blocks):
        i0 = b * bs
        i1 = n if b == blocks - 1 else min(n, (b + 1) * bs)
        C[i0:i1, i0:i1] -= 0.4
    C += noise * rng.normal(0.0, 1.0, (n, n))
    return np.maximum(C, 0.0).astype(np.float64)


def generate_noisy_linear_costs(
    n: int, rank: int = 1, noise: float = 0.1, seed: int = 42
) -> np.ndarray:
    """Low-rank outer product + Gaussian noise, shifted non-negative."""
    rng = _rng(seed)
    base = rng.normal(size=(n, rank)) @ rng.normal(size=(rank, n))
    C = base + rng.normal(scale=noise, size=(n, n))
    C -= C.min()
    return C.astype(np.float64)


def generate_worst_case_costs(n: int) -> np.ndarray:
    """Anti-diagonal structure |i - (n-1-j)| + 1."""
    idx = np.arange(n, dtype=np.float64)
    return (np.abs(idx[:, None] - (n - 1 - idx)[None, :]) + 1.0).astype(np.float64)


def generate_identity_like_costs(
    n: int, diagonal_cost: float = 0.0, off_diagonal_cost: float = 1.0
) -> np.ndarray:
    """Identity-optimal instance."""
    C = np.full((n, n), off_diagonal_cost, dtype=np.float64)
    np.fill_diagonal(C, diagonal_cost)
    return C


def generate_hard_random_costs(
    n: int, cost_range: Tuple[float, float] = (0.0, 100.0), seed: int = 42
) -> np.ndarray:
    """Uniform costs with added random row and column potentials."""
    rng = _rng(seed)
    low, high = cost_range
    C = rng.uniform(low, high, (n, n))
    span = (high - low) * 0.1
    C += rng.uniform(0.0, span, size=(n, 1))
    C += rng.uniform(0.0, span, size=(1, n))
    return C.astype(np.float64)


def generate_planted_optimum_instance(
    n: int, seed: int = 0, noise: float = 3e-3, dtype=np.float64
):
    """Cost matrix with a KNOWN optimal assignment, duals, and cost.

    C = u 1^T + 1 v^T + E with E >= 0.01 off a planted permutation and
    E = 0 on it: (u, v) are feasible duals tight exactly on the permutation,
    so it is optimal with cost sum over the permutation.  No O(n^3) oracle
    solve needed — usable at n = 8192+.  Returns (C, u_seed, perm, opt)
    where u_seed = u + N(0, noise) is a realistic GNN-quality warm start.

    Single source of truth for the dryrun (__graft_entry__), the scaling
    benchmark's warm-solve timing, and the sharded-solver tests (three
    hand-rolled copies had already drifted in parameters).
    """
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 1.0, n)
    v = rng.uniform(0.0, 1.0, n)
    E = rng.uniform(0.01, 1.0, (n, n))
    perm = rng.permutation(n)
    E[np.arange(n), perm] = 0.0
    C = (u[:, None] + v[None, :] + E).astype(dtype)
    opt = float(C.astype(np.float64)[np.arange(n), perm].sum())
    u_seed = (u + rng.normal(0.0, noise, n)).astype(dtype)
    return C, u_seed, perm, opt


# ---------------------------------------------------------------------------
# Dataset-side family registry.
# Callables take (n, rng) with an explicit numpy Generator.
# ---------------------------------------------------------------------------

def _seed_from(rng: np.random.Generator) -> int:
    return int(rng.integers(0, np.iinfo(np.uint32).max))


def _fam_uniform(n: int, rng: np.random.Generator) -> np.ndarray:
    return generate_uniform_costs(n, seed=_seed_from(rng))


def _fam_metric(n: int, rng: np.random.Generator) -> np.ndarray:
    return generate_metric_costs(n, seed=_seed_from(rng))


def _fam_low_rank(
    n: int, rng: np.random.Generator, rank: int = 12, sigma: float = 0.1
) -> np.ndarray:
    """Rank-12 bilinear + noise, clipped non-negative."""
    a = rng.normal(0.0, 1.0, size=(n, rank))
    b = rng.normal(0.0, 1.0, size=(n, rank))
    return np.maximum(a @ b.T + sigma * rng.normal(0.0, 1.0, size=(n, n)), 0.0).astype(
        np.float64
    )


def _fam_block(n: int, rng: np.random.Generator, blocks: int = 4, noise: float = 0.1) -> np.ndarray:
    return generate_clustered_costs(n, blocks=blocks, noise=noise, seed=_seed_from(rng))


def _fam_noisy_linear(
    n: int, rng: np.random.Generator, rank: int = 1, noise: float = 0.1
) -> np.ndarray:
    return generate_noisy_linear_costs(n, rank=rank, noise=noise, seed=_seed_from(rng))


def _fam_tie(n: int, rng: np.random.Generator, bins: int = 5, jitter: float = 1e-6) -> np.ndarray:
    """Tie-heavy: binned costs + microscopic jitter."""
    base = rng.integers(0, max(1, bins), size=(n, n)) / max(1, float(bins))
    return (base + jitter * rng.uniform(0.0, 1.0, size=(n, n))).astype(np.float64)


def _fam_sparse(n: int, rng: np.random.Generator, sparsity: float = 0.3) -> np.ndarray:
    """Dataset-style sparse: forbidden edges at 1e6."""
    C = generate_uniform_costs(n, seed=_seed_from(rng))
    keep = rng.random(size=(n, n)) < sparsity
    keep = _repair_feasibility(keep, rng)
    C[~keep] = DATASET_SPARSE_FORBIDDEN
    return C.astype(np.float64)


FAMILIES: Dict[str, Callable[[int, np.random.Generator], np.ndarray]] = {
    "uniform": _fam_uniform,
    "metric": _fam_metric,
    "low_rank": _fam_low_rank,
    "block": _fam_block,
    "clustered": _fam_block,  # alias of "block"
    "noisy_linear": _fam_noisy_linear,
    "tie": _fam_tie,
    "sparse": _fam_sparse,
}
# the JAX module's second name for the registry
SYNTHETIC_FAMILIES = FAMILIES
