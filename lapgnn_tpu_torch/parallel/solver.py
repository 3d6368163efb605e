"""Sharded end-to-end seeded solve: one instance's rows split over a mesh axis.

Port of ``lapgnn_tpu/parallel/solver.py``.  Each rank holds a contiguous
block of n/S rows of the (n, n) cost matrix and runs the unsharded solver's
own code (``solver.seeded.lapjv_seeded_single``) on it with the row
partition ``parallel.sharded.ShardedRows``: every O(n^2) pass runs on the
local block and only O(n) vectors cross ranks.  The matching (x, y) and the
duals v are held whole on every rank, and the host-side path flips run on
every rank alike.

  phase                      per rank              combine (O(n))
  -------------------------  --------------------  --------------------------
  feasibility projection     K2 on the block       MIN all-reduce
  gate counts                tight edges           SUM all-reduce
  greedy tight matching      proposals             column winners: MIN, MAX
  Jacobi ARR                 K4 bid on the block   column best / dv / owner:
                                                   MAX; winning row: MIN
  sweep augmentation         (n/S, n) relax        argmin combine (one MIN of
                                                   int64 keys a sweep)
  polish, cost               slack, picked costs   MAX; gathers of (n,)
  cold fallback              column minima         argmin combine, gather

Every row index a rank computes is global (the greedy's hash, the winners,
the predecessors), so the result is bit-equal to the unsharded solve of the
whole matrix.  ``assert_no_matrix_allgather`` reads the mesh's collective
log where the JAX package reads the compiled HLO.  On an axis of one rank
the block is every row: the factories run on a whole partition
(``parallel.sharded.serving_rows``), which makes no collective, and on the
card the solve takes the kernels S1-S3 as the unsharded one does.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from ..ops.dual import robust_normalize
from ..ops.partition import RowPartition
from ..ops.rank1 import rank1_duals, select_best_seed
from ..solver.jv import SolveStats
from ..solver.seeded import SeededResult, lapjv_seeded_single
from .mesh import Mesh
from .sharded import iter_topk, serving_rows, sharded_row_features

__all__ = [
    "assert_no_matrix_allgather",
    "make_sharded_pipeline",
    "make_sharded_seeded_solve",
]


def _rows(mesh: Mesh, axis: str, C: torch.Tensor) -> RowPartition:
    size = mesh.size(axis)
    if C.ndim != 2 or C.shape[0] * size != C.shape[1]:
        raise ValueError(
            f"a rank's block of a square instance is (n / {size}, n); got {tuple(C.shape)}"
        )
    return serving_rows(mesh, axis, C.shape[0])


def make_sharded_seeded_solve(
    mesh: Mesh,
    axis: str = "model",
    eps: float = 1e-12,
    gate: str = "both",
) -> Callable[..., SeededResult]:
    """Build solve(C_blk, u_blk, v_seed, stats=None) -> SeededResult: the
    rank's (n/S, n) rows of C and (n/S,) of the row seed, the (n,) column
    seed; the result (assignment, cost, duals v) is the whole one on every
    rank."""

    def solve(
        C_blk: torch.Tensor,
        u_blk: torch.Tensor,
        v_seed: torch.Tensor,
        stats: Optional[SolveStats] = None,
    ) -> SeededResult:
        part = _rows(mesh, axis, C_blk)
        return lapjv_seeded_single(C_blk, u_blk, v_seed, eps=eps, gate=gate, stats=stats, part=part)

    return solve


def make_sharded_pipeline(
    model: torch.nn.Module,
    mesh: Mesh,
    axis: str = "model",
    eps: float = 1e-12,
    gate: str = "both",
    use_cost_refinement: bool = True,
    normalize_costs: bool = True,
    seed_mode: str = "auto",
) -> Callable[..., SeededResult]:
    """The whole pipeline on ONE instance's row-sharded matrix:

        C (rows sharded) -> 21-D features (row-local + column-min combine)
          -> OneGNN (row-parallel MLP and top-k, gauge combined)
          -> seed: 'auto' picks the model's or the rank-1 seed by dual
             objective (each projected by the sharded min-trick), as the
             JAX pipeline does; 'gnn' the model's; 'rank1' the rank-1 one
          -> sharded seeded JV solve

    Returns run(C_blk, stats=None) -> SeededResult, C_blk the rank's (n/S, n)
    rows.  The model's weights are in the module, the same on every rank."""
    if seed_mode not in ("gnn", "rank1", "auto"):
        raise ValueError("seed_mode must be 'gnn', 'rank1', or 'auto'")
    model = iter_topk(model)

    @torch.inference_mode()
    def run(C_blk: torch.Tensor, stats: Optional[SolveStats] = None) -> SeededResult:
        part = _rows(mesh, axis, C_blk)
        C = C_blk[None]
        if seed_mode == "rank1":
            u = rank1_duals(C, part=part)[0][0]
            return lapjv_seeded_single(
                C_blk, u, part.min_trick(C_blk, u), eps=eps, gate=gate, stats=stats, part=part
            )
        C_in, mn, a = robust_normalize(C, part=part) if normalize_costs else (C, None, None)
        feats = sharded_row_features(C_in, part)
        refine = C_in if use_cost_refinement else None
        u = model(feats, cost=refine, row_reduce=part.reduce)["u"][0].to(C_blk.dtype)
        if normalize_costs:
            u = u * a + mn
        if seed_mode == "auto":
            u_r1 = rank1_duals(C, part=part)[0]
            u, v = select_best_seed(C, (u[None], u_r1), min_trick=part.min_trick, part=part)
            u, v = u[0], v[0]
        else:
            v = part.min_trick(C_blk, u)
        return lapjv_seeded_single(C_blk, u, v, eps=eps, gate=gate, stats=stats, part=part)

    return run


def assert_no_matrix_allgather(log: List[Tuple[str, int, str]], n: int, shards: int) -> None:
    """Fail if any logged collective moved an O(n^2)-sized operand.

    The sharded solve's contract is that collectives move only O(n)
    vectors; a block-sized one means the matrix went to every rank.  The
    JAX package's limit: up to 8n elements pass (vector combines of n + 1
    entries and the like), anything within 4x of a block (n^2 / shards)
    fails."""
    limit = max(8 * n, (n * n // shards) // 4)
    for op, numel, dtype in log:
        if numel > limit:
            raise AssertionError(
                f"the sharded solve moves {numel} {dtype} elements through {op} "
                f"(limit {limit}); the matrix is being replicated instead of partitioned"
            )
