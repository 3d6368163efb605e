"""Row-sharded serving and data-parallel training: each cost matrix's rows
split over the mesh's "model" axis, the batch over "data".

Port of ``lapgnn_tpu/parallel/sharded.py``.  Each rank
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
(``ops.dual.robust_normalize``, ``ops.rank1``, ``ops.sinkhorn``) on it, the
sharded solve (``parallel.solver``) the unsharded solver's, and the
data-parallel step (``make_dp_train_step``) the unsharded ``one_gnn_loss``
with gradients through the collectives (``parallel.collectives``).  The
loss's greedy bound needs whole instances: the step gathers the block's
cost and reduced-cost rows over "model" once, without gradient, and runs
the greedy kernel on them; JAX exchanges one row over the mesh at each of
the bound's n scan steps instead.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops.cuda.colmin import col_min, min_trick
from ..ops.features import positional_encodings, row_features
from ..ops.partition import RowPartition
from ..ops.rank1 import rank1_duals
from ..ops.sinkhorn import auto_select_seed
from ..train.loss import one_gnn_loss
from .collectives import (
    all_gather,
    all_reduce_max,
    all_reduce_min,
    all_reduce_sum,
    argmin_combine,
    float_of_ordered,
    ordered_int32,
    pvary,
    reduce_min,
)
from .mesh import Mesh

__all__ = [
    "BatchShard",
    "ShardedRows",
    "make_dp_train_step",
    "make_sharded_predict",
    "serving_rows",
    "shmap_col_min",
    "shmap_min_trick",
]


class ShardedRows(RowPartition):
    """One rank's block of ``rows`` consecutive rows along ``axis`` of
    ``mesh``: rank k holds rows [k rows, (k + 1) rows) of n = S rows.  Per-row
    vectors held whole are sliced on their last dimension; partial results
    are combined over the axis's group and logged in ``mesh.log``.  With
    ``batch_axis``, the rank's instances are its block of a batch split over
    that axis too (``batch_mean``)."""

    def __init__(self, mesh: Mesh, axis: str, rows: int, batch_axis: Optional[str] = None):
        self.size = mesh.size(axis)
        self.rows = rows
        self.n = rows * self.size
        self.offset = mesh.coordinate(axis) * rows
        self.group = mesh.group(axis)
        self.log = mesh.log
        self.batch_group = None if batch_axis is None else mesh.group(batch_axis)
        self.batch_parts = 1 if batch_axis is None else mesh.size(batch_axis)

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
        """``OneGNN``'s ``row_reduce``: the combined value, for this block's
        rows (so its gradient is the SUM of the ranks')."""
        return self.vary_rows(self.over_rows(t, op))

    def whole_shape(self, t: torch.Tensor) -> Tuple[int, int]:
        return self.n, t.shape[-1]

    def over_rows(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return {"sum": self.sum, "min": self.min, "max": self.max}[op](t)

    def vary_rows(self, t: torch.Tensor) -> torch.Tensor:
        return pvary(t, self.group, self.log)

    def amin_rows(self, t: torch.Tensor) -> torch.Tensor:
        return reduce_min(t, -2, self.group, self.log)

    @torch.no_grad()
    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        return all_gather(t, self.group, self.log, dim=-2)

    def batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        if self.batch_group is None:
            return t.mean()
        return _batch_mean(t, self.batch_group, self.batch_parts, self.log)


def _batch_mean(t: torch.Tensor, group, parts: int, log) -> torch.Tensor:
    """The mean over a batch split evenly over ``parts`` ranks: one SUM."""
    return all_reduce_sum(t.sum(), group, log) / float(t.numel() * parts)


class BatchShard(RowPartition):
    """Whole instances, the batch split over ``axis`` of ``mesh``."""

    def __init__(self, mesh: Mesh, axis: str = "data"):
        self.group = mesh.group(axis)
        self.parts = mesh.size(axis)
        self.log = mesh.log

    def batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        return _batch_mean(t, self.group, self.parts, self.log)


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


class _Alone(RowPartition):
    """Every row, held by the one rank of a serving axis: ``RowPartition``'s
    methods, which make no collective; the min-trick is kernel K2 and
    ``reduce`` the model's row reduction, as ``ShardedRows`` runs them on a
    block."""

    def min_trick(self, C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return min_trick(C.contiguous(), u.contiguous())

    def reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``OneGNN``'s ``row_reduce``: ``t`` already covers every row."""
        return t


def serving_rows(mesh: Mesh, axis: str, rows: int) -> RowPartition:
    """The partition the serving factories run a rank's block of ``rows``
    rows on: a whole one when ``axis`` has one rank (the block is every row:
    no collective, and the solver takes its kernels, ``solver.seeded``), a
    ``ShardedRows`` else."""
    return _Alone() if mesh.size(axis) == 1 else ShardedRows(mesh, axis, rows)


def sharded_row_features(C: torch.Tensor, part: RowPartition) -> torch.Tensor:
    """The sort-based 21-D features of a (B, n/S, n) block's rows."""
    rows = C.shape[-2]
    pos = positional_encodings(C.shape[-1], device=C.device)[part.offset : part.offset + rows]
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
        part = serving_rows(mesh, "model", cost.shape[-2])
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


def rank_generator(generator: Optional[torch.Generator], offset: int, device) -> Optional[torch.Generator]:
    """A generator of this rank's own: seeded with one draw from the
    caller's ``generator`` (the same on every rank) plus ``offset``, the
    rank's first global row, so that no two ranks draw the same dropout
    masks.  None without a generator."""
    if generator is None:
        return None
    seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device).item())
    return torch.Generator(device).manual_seed(seed + offset)


def sum_gradients(grads, group, log) -> List[torch.Tensor]:
    """The ranks' gradients summed over ``group`` (None: every rank), one
    all-reduce a parameter."""
    return [all_reduce_sum(g, group, log) for g in grads]


def make_dp_train_step(
    model: torch.nn.Module,
    optimizer,
    mesh: Mesh,
    use_cost: bool,
    shard_rows: bool = True,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Data-parallel (and, with ``shard_rows``, row-sharded) OneGNN step:
    ``step(cost, u_target, generator=None) -> metrics``, one update of
    ``optimizer.params`` (the model's, the same on every rank) in place.

    ``cost`` is this rank's block of the batch: its instances over "data"
    and, with ``shard_rows``, its rows over "model"
    (``batch_sharding(mesh, shard_n=shard_rows).local``); ``u_target`` the
    matching block of the target row duals.  The features are the block's
    (K1 on it, then a MIN); the model runs on the block with its gauge and
    pools combined over "model"; the loss is ``one_gnn_loss`` over the
    ``ShardedRows`` partition, its batch mean a SUM over "data".  The
    gradients are summed over every rank whose data differ (all of them;
    over "data" alone without ``shard_rows``, where the "model" ranks repeat
    one computation), so clipping and AdamW see equal gradients on every
    rank and the parameters stay equal.  The metrics (loss, primal_gap_mean,
    feas_mean, u_mse_mean) are the whole batch's, on every rank."""
    if shard_rows and use_cost:
        model = iter_topk(model)
    grad_group = None if shard_rows else mesh.group("data")

    def step(cost: torch.Tensor, u_target: torch.Tensor, generator=None) -> Dict[str, torch.Tensor]:
        B, n = cost.shape[0], cost.shape[-1]
        if shard_rows:
            part = ShardedRows(mesh, "model", cost.shape[-2], batch_axis="data")
            with torch.no_grad():
                feats = sharded_row_features(cost, part)
            row_reduce = part.reduce
        else:
            part = BatchShard(mesh, "data")
            with torch.no_grad():
                feats = row_features(cost)
            row_reduce = None
        first_row = mesh.coordinate("data") * B * n + part.offset
        gen = rank_generator(generator if model.dropout > 0 else None, first_row, cost.device)
        preds = model(feats, cost=cost if use_cost else None, generator=gen, row_reduce=row_reduce)
        loss, metrics = one_gnn_loss(cost, u_target, preds, part=part)
        grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True, materialize_grads=True)
        optimizer.step(sum_gradients(grads, grad_group, mesh.log))
        with torch.no_grad():
            return {
                "loss": loss.detach(),
                "primal_gap_mean": part.batch_mean(metrics["primal_gap"]),
                "feas_mean": part.batch_mean(metrics["feas"]),
                "u_mse_mean": part.batch_mean(metrics["u_mse"]),
            }

    return step
