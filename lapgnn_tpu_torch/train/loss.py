"""Training losses: primal gap + feasibility hinge + dual regression.

Port of ``lapgnn_tpu/train/loss.py`` (``masked_v_proj`` :65,
``greedy_primal_upper`` :115, ``_shared_terms`` :124, ``one_gnn_loss`` :165,
``dual_gnn_loss`` :197).  The greedy primal upper bound, a ``lax.scan`` over
the rows in JAX, is the hand-written kernel ``ops.cuda.greedy_total`` on a
CUDA tensor (its plain transcription on the CPU).

Gradients follow ``jax.grad`` of the JAX loss:
  * the min-trick's column minimum is ``torch.amin``, whose gradient splits a
    tie evenly among the tied rows, as ``jnp.min``'s does (``torch.min(dim=)``
    would give it all to one row);
  * the greedy bound adds entries of ``cost``, an input, at columns chosen by
    an argmin, so it carries no gradient in JAX; here it runs under
    ``torch.no_grad`` on detached inputs.  The gradient flows through the
    dual lower bound, the hinge and the regression term only.

Each loss takes a partition ``part`` (``ops.partition``, default ``WHOLE``:
the plain loss).  With a block of the matrix (``parallel.sharded.ShardedRows``,
rows split; ``parallel.dual.EdgeTiles``, rows and columns split), every sum,
minimum and mean over rows, columns or the batch combines through it, and a
vector held alike by several blocks enters each block's computation through
its ``vary_*`` methods, so the sharded losses are this code and their
gradients those of the whole loss (``parallel.collectives``).  The greedy
bound reads whole rows: a row partition gathers the block's rows for it,
without gradient.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.cuda.greedy import greedy_total
from ..ops.partition import WHOLE, EdgePartition
from ..ops.sentinels import BIG, clip_cost_sentinels

__all__ = [
    "BIG",
    "clip_cost_sentinels",
    "dual_gnn_loss",
    "greedy_primal_upper",
    "masked_v_proj",
    "one_gnn_loss",
]


def masked_v_proj(
    cost: torch.Tensor,
    u: torch.Tensor,
    mask: Optional[torch.Tensor],
    part: EdgePartition = WHOLE,
) -> torch.Tensor:
    """Min-trick column duals v_j = min_i (C_ij - u_i), masked rows and
    columns held at the ``BIG`` sentinel and masked v set to 0."""
    cm = cost - part.vary_cols(u)[..., :, None]
    if mask is not None:
        cm = torch.where(mask[..., :, None], cm, BIG)
        cm = torch.where(mask[..., None, :], cm, BIG)
    v = part.amin_rows(cm)
    if mask is not None:
        v = torch.where(mask, v, 0.0)
    return v


@torch.no_grad()
def greedy_primal_upper(
    cost: torch.Tensor, reduced: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Batched greedy primal upper bound: (B, n, n) -> (B,).

    Rows are visited in ascending order of their minimum reduced cost
    (masked rows last, a stable sort as ``jnp.argsort``'s); each takes its
    cheapest still-unused column by reduced cost and adds its cost.  Equal to
    the JAX function bit for bit on equal inputs."""
    cost = cost.detach().to(torch.float32).contiguous()
    red = reduced.detach().to(torch.float32)
    if mask is not None:
        red = torch.where(mask[..., :, None] & mask[..., None, :], red, torch.inf)
    row_min = red.amin(-1)
    if mask is not None:
        row_min = torch.where(mask, row_min, torch.inf)  # masked rows visit last
    order = torch.argsort(row_min, dim=-1, stable=True)
    return greedy_total(red.contiguous(), cost, order, None if mask is None else mask.contiguous())


def _shared_terms(cost, u_pred, mask, include_primal=True, part=WHOLE):
    if mask is not None:
        if part is not WHOLE:
            raise ValueError("a partitioned loss takes no mask")
        mf_r = mf_c = mask.to(cost.dtype)
        u_pred = torch.where(mask, u_pred, 0.0)
    else:
        mf_r = torch.ones(cost.shape[:-1], dtype=cost.dtype, device=cost.device)
        mf_c = torch.ones(cost.shape[:-2] + cost.shape[-1:], dtype=cost.dtype, device=cost.device)
    v_proj = masked_v_proj(cost, u_pred, mask, part)

    dual_lower = part.over_rows((u_pred * mf_r).sum(-1)) + part.over_cols((v_proj * mf_c).sum(-1))

    u_e, v_e = part.vary_cols(u_pred), part.vary_rows(v_proj)
    hinge = torch.relu(u_e[..., :, None] + v_e[..., None, :] - cost)
    if mask is not None:
        m2 = (mask[..., :, None] & mask[..., None, :]).to(cost.dtype)
        hinge = hinge * m2
        entries = torch.clamp_min(m2.sum((-2, -1)), 1.0)
    else:
        rows, cols = part.whole_shape(cost)
        entries = float(rows * cols)
    feas = part.sum(hinge.sum((-2, -1))) / entries

    if include_primal:
        reduced = cost - u_e[..., :, None] - v_e[..., None, :]
        primal_upper = greedy_primal_upper(part.gather_rows(cost), part.gather_rows(reduced), mask)
        primal_gap = primal_upper - dual_lower
    else:
        # Surrogate without the sequential bound: maximise the dual lower
        # bound against the row- and column-minimum anchor, masked entries
        # left out of it.
        if mask is not None:
            m2b = mask[..., :, None] & mask[..., None, :]
            cm = torch.where(m2b, cost, torch.inf)
            rmin = torch.where(mask, cm.amin(-1), 0.0)
            cmin = torch.where(mask, cm.amin(-2), 0.0)
        else:
            rmin = part.amin_cols(cost)
            cmin = part.amin_rows(cost)
        anchor = part.over_rows(rmin.sum(-1)) + part.over_cols(cmin.sum(-1))
        primal_gap = anchor - dual_lower
    return u_pred, v_proj, (mf_r, mf_c), primal_gap, feas


def one_gnn_loss(
    cost: torch.Tensor,
    u_target: torch.Tensor,
    preds: Dict[str, torch.Tensor],
    mask: Optional[torch.Tensor] = None,
    normalize_gap: bool = False,
    include_primal: bool = True,
    part: EdgePartition = WHOLE,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """loss = mean primal_gap + mean feas + 0.1 * mean u-MSE.

    ``normalize_gap`` divides the primal gap by the instance size;
    ``include_primal=False`` replaces the greedy bound by the dual
    surrogate."""
    u_pred, v_proj, (mf, _), primal_gap, feas = _shared_terms(
        cost, preds["u"], mask, include_primal, part
    )
    cnt = torch.clamp_min(part.over_rows(mf.sum(-1)), 1.0)
    u_reg = part.over_rows((((u_pred - u_target) ** 2) * mf).sum(-1)) / cnt
    gap_term = primal_gap / cnt if normalize_gap else primal_gap
    mean = part.batch_mean
    loss = mean(gap_term) + mean(feas) + 0.1 * mean(u_reg)
    metrics = {
        "primal_gap": primal_gap,
        "feas": feas,
        "u_mse": u_reg,
        "v_proj": v_proj,
    }
    return loss, metrics


def dual_gnn_loss(
    cost: torch.Tensor,
    preds: Dict[str, torch.Tensor],
    mask: Optional[torch.Tensor] = None,
    normalize_gap: bool = False,
    clip_sentinels: bool = False,
    u_target: Optional[torch.Tensor] = None,
    include_primal: bool = True,
    part: EdgePartition = WHOLE,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """loss = mean primal_gap + mean feas + 0.1 * MSE(v_hint, v_proj).

    ``clip_sentinels`` computes the loss on the sentinel-clipped matrix;
    ``u_target`` adds 0.1 * the gauge-corrected MSE(u, u*) (the per-instance
    mean difference removed, since (u + c, v - c) is the same dual point)."""
    if clip_sentinels:
        cost = clip_cost_sentinels(cost, mask, part=part)
    u_pred, v_proj, (mf, mf_c), primal_gap, feas = _shared_terms(
        cost, preds["u"], mask, include_primal, part
    )
    cnt = torch.clamp_min(part.over_rows(mf.sum(-1)), 1.0)
    v_reg = part.over_cols((((preds["v_hint"] - v_proj) ** 2) * mf_c).sum(-1)) / cnt
    gap_term = primal_gap / cnt if normalize_gap else primal_gap
    mean = part.batch_mean
    loss = mean(gap_term) + mean(feas) + 0.1 * mean(v_reg)
    metrics = {
        "primal_gap": primal_gap,
        "feas": feas,
        "v_mse": v_reg,
        "v_proj": v_proj,
    }
    if u_target is not None:
        diff = (u_pred - u_target) * mf
        shift = part.vary_rows(part.over_rows(diff.sum(-1, keepdim=True)) / cnt[..., None])
        u_reg = part.over_rows(((diff - shift * mf) ** 2).sum(-1)) / cnt
        loss = loss + 0.1 * mean(u_reg)
        metrics["u_mse_gauge"] = u_reg
    return loss, metrics
