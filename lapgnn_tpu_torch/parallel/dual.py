"""2-D (row x col) edge partitioning of the DualGNN: the model whose
O(n²·hidden) edge activations do not fit one device at large n.

Port of ``lapgnn_tpu/parallel/dual.py``.  On a ('row', 'col') mesh
(``dual_mesh``) rank (r, c) holds tile (r, c) of every cost matrix: rows
[r n/R, (r + 1) n/R) and columns [c n/C, (c + 1) n/C).  ``EdgeTiles`` is
that tile's edge partition (``ops.partition.EdgePartition``):

  * the dense graph features: whole rows of the tile's row block are one
    all-gather of the tiles over 'col', whole columns of its column block
    one over 'row' (O(n²/R) and O(n²/C) cost-matrix elements, which JAX lets
    GSPMD move too); the tile's edge features, its rows' and its columns'
    features are then computed locally (``ops.features.graph_features``);
  * the DualGNN on the tile (``DualGNN.forward(part=)``): row embeddings
    live with their row block, column embeddings with their column block,
    the edge features and every layer's edge activations stay in the tile;
    the attention's softmax and messages combine over one axis each, the
    gauge over 'row';
  * the loss (``train.loss.dual_gnn_loss(part=)``): the sentinel clip's
    maximum over every tile, the column minima over 'row', the row minima
    over 'col', each per-row (per-column) sum over the owning axis alone.

The gradients follow ``parallel.collectives``: after the backward each rank
holds, for each parameter, its share of the computation that reads it.  A
weight of the row side (the row encoder, projections, update and head, the
row slices of the attention weights) is read alike by the tiles of one row
block, so its gradient is SUMed over 'row' only; the column side's over
'col'; the edge MLP's and the attention's edge terms over every rank.
AdamW then runs on equal gradients on every rank.

JAX checks what the compiled program's collectives move
(``assert_no_edge_tensor_gather`` on HLO text); here every collective is
logged in ``Mesh.log``, forward and backward, and the same function reads
that log.  Dropout draws per tile on the edges and per row (column) block
on the rows (columns), so the tiles of one block compute its nodes alike.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from ..ops.cuda.colmin import min_trick
from ..ops.features import graph_features
from ..ops.partition import EdgePartition
from ..train.loss import dual_gnn_loss
from .collectives import (
    all_gather,
    all_reduce_max,
    all_reduce_min,
    all_reduce_sum,
    pvary,
    reduce_min,
)
from .mesh import Mesh, NamedSharding, P, make_mesh

__all__ = [
    "EdgeTiles",
    "assert_no_edge_tensor_gather",
    "dual_mesh",
    "local_tile",
    "make_sharded_dual_eval_step",
    "make_sharded_dual_predict",
    "make_sharded_dual_train_step",
    "require_dual_mesh",
]

_COMBINE = {"sum": all_reduce_sum, "min": all_reduce_min, "max": all_reduce_max}


def dual_mesh(row: int = 0, col: int = 0, device: Optional[Union[str, torch.device]] = None,
              **mesh_kw) -> Mesh:
    """A ('row', 'col') mesh over every rank of the process group: the most
    square factorisation with row >= col by default; one axis given derives
    the other; both given must multiply to the world size.  ``device`` and
    ``mesh_kw`` as in ``make_mesh``."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("dual_mesh needs a process group: call initialize_distributed() first")
    d = dist.get_world_size()
    if row and col:
        if row * col != d:
            raise ValueError(f"row*col = {row * col} != {d} devices")
    elif row or col:
        fixed = row or col
        if d % fixed != 0:
            raise ValueError(f"{'row' if row else 'col'}={fixed} does not divide {d} devices")
        row, col = (row, d // row) if row else (d // col, col)
    else:
        row = math.isqrt(d)
        while d % row != 0:
            row -= 1
        row, col = max(row, d // row), min(row, d // row)
    return make_mesh(row, col, device=device, axis_names=("row", "col"), **mesh_kw)


def local_tile(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's tile of a (..., n, n) matrix every rank holds."""
    return NamedSharding(mesh, P(*(None,) * (x.ndim - 2), "row", "col")).local(x)


def require_dual_mesh(mesh: Mesh) -> None:
    """Raise unless ``mesh`` has the ('row', 'col') axes of ``dual_mesh``."""
    if "row" not in mesh.axis_names or "col" not in mesh.axis_names:
        raise ValueError("mesh must have ('row', 'col') axes — see dual_mesh()")


class EdgeTiles(EdgePartition):
    """Tile (r, c) of a ('row', 'col') mesh: ``rows`` rows from
    ``row_offset`` and ``cols`` columns from ``col_offset``.  Combines over
    'row' join the row blocks, over 'col' the column blocks, ``sum`` /
    ``min`` / ``max`` every tile; each logged in ``mesh.log``."""

    def __init__(self, mesh: Mesh, rows: int, cols: int):
        require_dual_mesh(mesh)
        self.row_parts, self.col_parts = mesh.size("row"), mesh.size("col")
        self.rows, self.cols = rows, cols
        self.n_rows, self.n_cols = rows * self.row_parts, cols * self.col_parts
        self.row_offset = mesh.coordinate("row") * rows
        self.col_offset = mesh.coordinate("col") * cols
        self.row_group, self.col_group = mesh.group("row"), mesh.group("col")
        self.log = mesh.log

    def min(self, t):
        return all_reduce_min(t, None, self.log)

    def max(self, t):
        return all_reduce_max(t, None, self.log)

    def sum(self, t):
        return all_reduce_sum(t, None, self.log)

    def whole_shape(self, t):
        return self.n_rows, self.n_cols

    def over_rows(self, t, op="sum"):
        return _COMBINE[op](t, self.row_group, self.log)

    def over_cols(self, t, op="sum"):
        return _COMBINE[op](t, self.col_group, self.log)

    def vary_rows(self, t):
        return pvary(t, self.row_group, self.log)

    def vary_cols(self, t):
        return pvary(t, self.col_group, self.log)

    def amin_rows(self, t):
        return reduce_min(t, -2, self.row_group, self.log)

    def amin_cols(self, t):
        return reduce_min(t, -1, self.col_group, self.log)

    def gather_rows(self, t):
        raise NotImplementedError(
            "a tile has no whole rows for the greedy bound: use include_primal=False")

    @torch.no_grad()
    def whole_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every column of the tile's rows: one all-gather over 'col'."""
        return all_gather(t, self.col_group, self.log, dim=-1)

    @torch.no_grad()
    def whole_cols(self, t: torch.Tensor) -> torch.Tensor:
        """Every row of the tile's columns: one all-gather over 'row'."""
        return all_gather(t, self.row_group, self.log, dim=-2)

    def features(self, cost: torch.Tensor):
        """``graph_features`` of the tile."""
        return graph_features(cost, constrain_rows=self.whole_rows, constrain_cols=self.whole_cols,
                              offsets=(self.row_offset, self.col_offset))

    def dropout_seeds(self, seed: int) -> Tuple[int, int, int]:
        """Seeds of the tile's edge masks, of its row block's and of its
        column block's: each block's the same on every tile of it."""
        n2 = self.n_rows * self.n_cols
        return ((seed + self.row_offset * self.n_cols + self.col_offset) % 2**63,
                (seed + n2 + self.row_offset) % 2**63,
                (seed + n2 + self.n_rows + self.col_offset) % 2**63)


def make_sharded_dual_predict(model: torch.nn.Module, mesh: Mesh, project: bool = True):
    """``predict(cost) -> (u, v)``: ``cost`` this rank's (B, n/R, n/C) tile
    (``local_tile``), u and v (B, n) whole on every rank.  ``project=True``
    returns the min-trick v = min_i (C_ij - u_i): K2 on the tile, a MIN over
    'row', then a gather over 'col'; ``project=False`` the model's v_hint.
    The model's weights are in the module, the same on every rank."""
    require_dual_mesh(mesh)

    @torch.inference_mode()
    def predict(cost: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cost = cost.to(torch.float32)
        part = EdgeTiles(mesh, cost.shape[-2], cost.shape[-1])
        gf = part.features(cost)
        preds = model(gf.edge_feat, gf.row_feat, gf.col_feat, part=part)
        u_rows = preds["u"].to(cost.dtype)
        u = all_gather(u_rows, part.row_group, part.log, dim=-1)
        if project:
            v = part.over_rows(min_trick(cost.contiguous(), u_rows.contiguous()), "min")
        else:
            v = preds["v_hint"].to(cost.dtype)
        return u, all_gather(v, part.col_group, part.log, dim=-1)

    return predict


def _grad_axes(name: str) -> List[Tuple[Union[slice, Tuple], str]]:
    """Where each part of the parameter ``name`` is read: ("row", the row
    side), ("col", the column side) or ("all", the tile's edges), with the
    index of that part."""
    parts = name.split(".")
    key = parts[-1] if parts[-1].startswith("attn") else parts[-2]
    if key in ("attn_row", "attn_col"):
        # [:, 0] the receiver's term, [:, 1] the sender's, [:, 2] the edge's
        recv, send = ("row", "col") if key == "attn_row" else ("col", "row")
        return [((slice(None), 0), recv), ((slice(None), 1), send), ((slice(None), 2), "all")]
    if key.startswith(("attn_", "edge_")):
        return [(slice(None), "all")]
    if key.startswith("row_"):
        return [(slice(None), "row")]
    if key.startswith("col_"):
        return [(slice(None), "col")]
    raise ValueError(f"no side of the tile is known for parameter {name!r}")


def _sum_tile_gradients(names, grads, part: EdgeTiles) -> List[torch.Tensor]:
    """Each parameter's gradient SUMed over the axes on which its reads
    differ: one all-reduce a parameter (a slice of the attention weights),
    over 'row' for the row side, 'col' for the column side, every rank for
    the edge parts."""
    groups = {"row": part.row_group, "col": part.col_group, "all": None}
    out = []
    for name, g in zip(names, grads):
        g = g.clone()
        for idx, side in _grad_axes(name):
            g[idx] = all_reduce_sum(g[idx], groups[side], part.log)
        out.append(g)
    return out


def make_sharded_dual_train_step(
    model: torch.nn.Module,
    optimizer,
    mesh: Mesh,
    clip_sentinels: bool = True,
    normalize_gap: bool = True,
    supervise_duals: bool = True,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(cost, u_target, generator=None) -> metrics``: one update of
    ``optimizer.params`` (the model's, the same on every rank) in place.
    ``cost`` is this rank's (B, n/R, n/C) tile, ``u_target`` the (B, n/R)
    target duals of its rows.

    The loss is ``dual_gnn_loss(include_primal=False)``, as in JAX: the
    greedy bound visits the rows in sequence and would need whole rows; the
    dual surrogate keeps every term a combine over one axis.  Every edge
    tensor, with its gradient, stays in its tile, so a rank's memory is
    O(B n² hidden / (R C)).  Each parameter's gradient is one all-reduce.  The metrics (loss, primal_gap_mean, feas_mean,
    v_mse_mean) are the batch's, on every rank."""
    require_dual_mesh(mesh)
    names = [n for n, _ in model.named_parameters()]
    by_tensor = {id(p): n for n, p in model.named_parameters()}
    param_names = [by_tensor[id(p)] for p in optimizer.params]
    if sorted(param_names) != sorted(names):
        raise ValueError("the optimizer must hold every parameter of the model")

    def step(cost: torch.Tensor, u_target: torch.Tensor, generator=None) -> Dict[str, torch.Tensor]:
        cost = cost.to(torch.float32)
        part = EdgeTiles(mesh, cost.shape[-2], cost.shape[-1])
        with torch.no_grad():
            gf = part.features(cost)
        gen = generator if model.dropout > 0 else None
        preds = model(gf.edge_feat, gf.row_feat, gf.col_feat, generator=gen, part=part)
        loss, metrics = dual_gnn_loss(
            cost, preds, normalize_gap=normalize_gap, clip_sentinels=clip_sentinels,
            u_target=u_target if supervise_duals else None, include_primal=False, part=part,
        )
        grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True, materialize_grads=True)
        optimizer.step(_sum_tile_gradients(param_names, grads, part))
        return {
            "loss": loss.detach(),
            "primal_gap_mean": metrics["primal_gap"].detach().mean(),
            "feas_mean": metrics["feas"].detach().mean(),
            "v_mse_mean": metrics["v_mse"].detach().mean(),
        }

    return step


def make_sharded_dual_eval_step(
    model: torch.nn.Module,
    mesh: Mesh,
    clip_sentinels: bool = True,
    normalize_gap: bool = True,
) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """``step(cost) -> {primal_gap, feas}`` per instance on every rank, from
    this rank's tile, without dropout or gradients.  The gap is the dual
    surrogate's (``include_primal=False``), as in JAX: comparable across
    epochs, not with the greedy-bound gap of the unsharded step."""
    require_dual_mesh(mesh)

    @torch.no_grad()
    def step(cost: torch.Tensor) -> Dict[str, torch.Tensor]:
        cost = cost.to(torch.float32)
        part = EdgeTiles(mesh, cost.shape[-2], cost.shape[-1])
        gf = part.features(cost)
        preds = model(gf.edge_feat, gf.row_feat, gf.col_feat, part=part)
        _, metrics = dual_gnn_loss(cost, preds, normalize_gap=normalize_gap,
                                   clip_sentinels=clip_sentinels, include_primal=False, part=part)
        return {"primal_gap": metrics["primal_gap"], "feas": metrics["feas"]}

    return step


def assert_no_edge_tensor_gather(log: List[Tuple[str, int, str]], n: int, batch: int = 1) -> None:
    """Fail if a logged collective (forward or backward) moved more than
    3n²/2 elements an instance of a ``batch``: cost-matrix-sized regathers
    (whole rows or columns of a tile's blocks for the features' sorts) pass;
    an (n, n, feat) or (n, n, hidden) edge tensor would not, which would mean
    the partitioned work was replicated.  A parameter's gradient all-reduce
    is of its size, so the check means something once 3n²/2 exceeds the
    largest parameter (at r5's width the (256, 512) update weights:
    n >= 296)."""
    limit = batch * (3 * n * n) // 2
    for op, numel, dtype in log:
        if numel > limit:
            raise AssertionError(
                f"the sharded DualGNN moves {numel} {dtype} elements through {op} "
                f"(limit {limit}); an edge tensor is being replicated instead of tiled"
            )
