"""Row-sharded serving: the predict path with each cost matrix's rows split
over the mesh's "model" axis.

Port of ``lapgnn_tpu/parallel/sharded.py`` (its serving half).  Each rank
holds a contiguous block of n/S rows of each instance of its share of the
batch, and every pass over the matrix runs on that block; what crosses ranks
is O(n) a collective, through ``parallel.collectives``:

  * 21-D row features: row-local, but for the is-col-best channel, which
    needs the column minimum of every row (K1 on the block, then a MIN
    all-reduce), and the positional encodings of the block's global rows.
  * OneGNN: per-row MLP and per-row top-k, row-local; the gauge (the mean
    of u over every row) is one SUM all-reduce.
  * min-trick v_j = min_i (C_ij - u_i): K2 on the block, then a MIN
    all-reduce (``shmap_min_trick``).
  * the 'auto' seed policy: the rank-1 fit's matvecs with SUM all-reduces
    and its factor gathered (one (n,) vector an instance) for the argsort;
    each Sinkhorn column pass a local logsumexp and a max / sum combine; the
    collision veto's count of distinct argmin columns a MAX all-reduce of a
    (n,) mask; the temperature scale's strided quantile sample (at most
    65,536 entries an instance) gathered.

``ShardedRows`` is the row partition (``ops.partition``) of one rank's
block: the predict here runs the unsharded seed policy's code
(``ops.dual.robust_normalize``, ``ops.rank1``, ``ops.sinkhorn``) on it, and
the sharded solve (``parallel.solver``) the unsharded solver's.

Not ported yet (the training half of this module and ``parallel/dual.py``):
``make_dp_train_step``, and the 2-D edge-partitioned DualGNN's
``dual_mesh``, ``make_sharded_dual_predict``, ``make_sharded_dual_train_step``,
``make_sharded_dual_eval_step`` and ``assert_no_edge_tensor_gather``.
"""

from __future__ import annotations

import copy
from typing import Callable, Tuple

import torch

from ..ops.cuda.colmin import col_min, min_trick
from ..ops.features import positional_encodings, row_features
from ..ops.partition import RowPartition
from ..ops.rank1 import rank1_duals
from ..ops.sinkhorn import auto_select_seed
from .collectives import (
    all_gather,
    all_reduce_max,
    all_reduce_min,
    all_reduce_sum,
    argmin_combine,
    float_of_ordered,
    ordered_int32,
)
from .mesh import Mesh

__all__ = [
    "ShardedRows",
    "make_sharded_predict",
    "shmap_col_min",
    "shmap_min_trick",
]


class ShardedRows(RowPartition):
    """One rank's block of ``rows`` consecutive rows along ``axis`` of
    ``mesh``: rank k holds rows [k rows, (k + 1) rows) of n = S rows.  Per-row
    vectors held whole are sliced on their last dimension; partial results
    are combined over the axis's group and logged in ``mesh.log``."""

    def __init__(self, mesh: Mesh, axis: str, rows: int):
        self.size = mesh.size(axis)
        self.rows = rows
        self.n = rows * self.size
        self.offset = mesh.coordinate(axis) * rows
        self.group = mesh.group(axis)
        self.log = mesh.log

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return x.narrow(-1, self.offset, self.rows)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return all_gather(t, self.group, self.log, dim=-1)

    def min(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_min(t, self.group, self.log)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_max(t, self.group, self.log)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(t, self.group, self.log)

    def argmin(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        values, rows = torch.min(t, dim=0)
        return argmin_combine(values, rows + self.offset, self.group, self.log)

    def min_trick(self, C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """K2 on the block ((n/S, m) or (B, n/S, m)), then the MIN combine."""
        return self.min(min_trick(C.contiguous(), u.contiguous()))

    def best_bid(
        self, cols: torch.Tensor, gaps: torch.Tensor, rows: torch.Tensor, n: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One MAX all-reduce for float32 gaps: each bid's int64 key holds
        the gap's order-preserving int32 above and 2^32 - 1 - row below, so
        the largest key is the largest gap and, on a tie, the lowest row."""
        if gaps.dtype != torch.float32:
            return super().best_bid(cols, gaps, rows, n)
        low = torch.iinfo(torch.int64).min
        key = (ordered_int32(gaps).to(torch.int64) << 32) | (0xFFFFFFFF - rows)
        key = torch.full((n + 1,), low, dtype=torch.int64, device=gaps.device).scatter_reduce_(
            0, cols, torch.where(cols < n, key, low), "amax"
        )
        key = self.max(key)
        got = key != low
        col_best = torch.where(got, float_of_ordered(key >> 32), float("-inf"))
        return col_best, torch.where(got, 0xFFFFFFFF - (key & 0xFFFFFFFF), n)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        return self.sum(t.sum((-2, -1))) / float(self.n * t.shape[-1])

    def norm(self, y: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.sum((y * y).sum(-1, keepdim=True)))

    def logsumexp(self, z: torch.Tensor) -> torch.Tensor:
        """The block's logsumexp over its rows, then the ranks' combined
        under their maximum."""
        lse = torch.logsumexp(z, dim=-2)
        top = self.max(lse)
        top = torch.where(torch.isinf(top), 0.0, top)
        return torch.log(self.sum(torch.exp(lse - top))) + top

    def sample_rows(self, t: torch.Tensor, stride: int) -> torch.Tensor:
        """The block's rows at the global stride, gathered one instance at a
        time (each gather within the sample's own size) in global order."""
        B, nl, _ = t.shape
        counts = [len(range((-k * nl) % stride, nl, stride)) for k in range(self.size)]
        block = t[..., (-self.offset) % stride :: stride, :]
        pad = max(counts) - block.shape[-2]
        if pad:
            block = torch.cat([block, block.new_zeros((B, pad, block.shape[-1]))], dim=-2)
        out = []
        for b in range(B):
            g = all_gather(block[b], self.group, self.log, dim=0).reshape(self.size, max(counts), -1)
            out.append(torch.cat([g[k, : counts[k]] for k in range(self.size)]))
        return torch.stack(out)

    def reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``OneGNN``'s ``row_reduce``."""
        return self.sum(t) if op == "sum" else self.max(t)


def shmap_col_min(mesh: Mesh, axis: str = "model") -> Callable[[torch.Tensor], torch.Tensor]:
    """Column minimum of a row-sharded C: f(C_blk) -> (m,), the rank's
    (n/S, m) rows in, every row's minimum out on every rank (K1 on the
    block, then a MIN all-reduce)."""
    return lambda C_blk: ShardedRows(mesh, axis, C_blk.shape[-2]).min(col_min(C_blk.contiguous()))


def shmap_min_trick(
    mesh: Mesh, axis: str = "model"
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Min-trick over row-sharded (C, u): f(C_blk, u_blk) -> v (m,) on every
    rank (K2 on the block, then a MIN all-reduce)."""
    return lambda C_blk, u_blk: ShardedRows(mesh, axis, C_blk.shape[-2]).min_trick(C_blk, u_blk)


def sharded_row_features(C: torch.Tensor, part: ShardedRows) -> torch.Tensor:
    """The sort-based 21-D features of a (B, n/S, n) block's rows."""
    pos = positional_encodings(part.n, device=C.device)[part.offset : part.offset + part.rows]
    return row_features(C, col_min=part.min(col_min(C.contiguous())), pos=pos)


def iter_topk(model: torch.nn.Module) -> torch.nn.Module:
    """The model itself, or a shallow copy sharing its weights that takes its
    top k by rounds of argmin (``topk_impl="iter"``), as the JAX package
    clones its model for a row-sharded cost."""
    if getattr(model, "topk_impl", None) != "top_k":
        return model
    clone = copy.copy(model)
    clone.topk_impl = "iter"
    return clone


def make_sharded_predict(
    model: torch.nn.Module,
    mesh: Mesh,
    use_cost_refinement: bool = True,
    seed_mode: str = "auto",
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Build predict(cost) -> (u, v): ``cost`` is this rank's block of the
    batch, (B / data, n / model, n), its instances over 'data' and its rows
    over 'model' (``batch_sharding(mesh, shard_n=True).local``); u comes back
    for the block's rows, v for every column.  The model's weights are in
    the module (on ``mesh.device``), the same on every rank.

    ``seed_mode`` as in ``pipeline.predict_duals_fn``: 'gnn' the model's
    seed, 'rank1' the closed-form rank-1 seed, 'auto' the selection among
    the model seed, the rank-1 seed and the Sinkhorn-refined winner.  The
    model seed comes from the sort-based row features, as in the JAX
    package's sharded predict (the unsharded one runs K3)."""
    if seed_mode not in ("gnn", "rank1", "auto"):
        raise ValueError("seed_mode must be 'gnn', 'rank1', or 'auto'")
    model = iter_topk(model)

    @torch.inference_mode()
    def predict(cost: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        part = ShardedRows(mesh, "model", cost.shape[-2])
        if seed_mode == "rank1":
            u, _ = rank1_duals(cost, part=part)
            return u, part.min_trick(cost, u)
        feats = sharded_row_features(cost, part)
        refine = cost if use_cost_refinement else None
        u = model(feats, cost=refine, row_reduce=part.reduce)["u"].to(cost.dtype)
        if seed_mode == "auto":
            return auto_select_seed(cost, u, min_trick=part.min_trick, part=part)
        return u, part.min_trick(cost, u)

    return predict
