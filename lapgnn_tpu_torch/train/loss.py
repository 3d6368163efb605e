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
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.cuda.greedy import greedy_total
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
    cost: torch.Tensor, u: torch.Tensor, mask: Optional[torch.Tensor]
) -> torch.Tensor:
    """Min-trick column duals v_j = min_i (C_ij - u_i), masked rows and
    columns held at the ``BIG`` sentinel and masked v set to 0."""
    cm = cost - u[..., :, None]
    if mask is not None:
        cm = torch.where(mask[..., :, None], cm, BIG)
        cm = torch.where(mask[..., None, :], cm, BIG)
    v = cm.amin(-2)
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


def _shared_terms(cost, u_pred, mask, include_primal=True):
    if mask is not None:
        mf = mask.to(cost.dtype)
        u_pred = torch.where(mask, u_pred, 0.0)
    else:
        mf = torch.ones(cost.shape[:-1], dtype=cost.dtype, device=cost.device)
    v_proj = masked_v_proj(cost, u_pred, mask)

    dual_lower = (u_pred * mf).sum(-1) + (v_proj * mf).sum(-1)

    hinge = torch.relu(u_pred[..., :, None] + v_proj[..., None, :] - cost)
    if mask is not None:
        m2 = (mask[..., :, None] & mask[..., None, :]).to(cost.dtype)
        hinge = hinge * m2
        entries = torch.clamp_min(m2.sum((-2, -1)), 1.0)
    else:
        entries = float(cost.shape[-1] * cost.shape[-2])
    feas = hinge.sum((-2, -1)) / entries

    if include_primal:
        reduced = cost - u_pred[..., :, None] - v_proj[..., None, :]
        primal_upper = greedy_primal_upper(cost, reduced, mask)
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
            rmin = cost.amin(-1)
            cmin = cost.amin(-2)
        anchor = rmin.sum(-1) + cmin.sum(-1)
        primal_gap = anchor - dual_lower
    return u_pred, v_proj, mf, primal_gap, feas


def one_gnn_loss(
    cost: torch.Tensor,
    u_target: torch.Tensor,
    preds: Dict[str, torch.Tensor],
    mask: Optional[torch.Tensor] = None,
    normalize_gap: bool = False,
    include_primal: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """loss = mean primal_gap + mean feas + 0.1 * mean u-MSE.

    ``normalize_gap`` divides the primal gap by the instance size;
    ``include_primal=False`` replaces the greedy bound by the dual
    surrogate."""
    u_pred, v_proj, mf, primal_gap, feas = _shared_terms(
        cost, preds["u"], mask, include_primal
    )
    cnt = torch.clamp_min(mf.sum(-1), 1.0)
    u_reg = (((u_pred - u_target) ** 2) * mf).sum(-1) / cnt
    gap_term = primal_gap / cnt if normalize_gap else primal_gap
    loss = gap_term.mean() + feas.mean() + 0.1 * u_reg.mean()
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
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """loss = mean primal_gap + mean feas + 0.1 * MSE(v_hint, v_proj).

    ``clip_sentinels`` computes the loss on the sentinel-clipped matrix;
    ``u_target`` adds 0.1 * the gauge-corrected MSE(u, u*) (the per-instance
    mean difference removed, since (u + c, v - c) is the same dual point)."""
    if clip_sentinels:
        cost = clip_cost_sentinels(cost, mask)
    u_pred, v_proj, mf, primal_gap, feas = _shared_terms(
        cost, preds["u"], mask, include_primal
    )
    cnt = torch.clamp_min(mf.sum(-1), 1.0)
    v_reg = (((preds["v_hint"] - v_proj) ** 2) * mf).sum(-1) / cnt
    gap_term = primal_gap / cnt if normalize_gap else primal_gap
    loss = gap_term.mean() + feas.mean() + 0.1 * v_reg.mean()
    metrics = {
        "primal_gap": primal_gap,
        "feas": feas,
        "v_mse": v_reg,
        "v_proj": v_proj,
    }
    if u_target is not None:
        diff = (u_pred - u_target) * mf
        shift = diff.sum(-1, keepdim=True) / cnt[..., None]
        u_reg = ((diff - shift * mf) ** 2).sum(-1) / cnt
        loss = loss + 0.1 * u_reg.mean()
        metrics["u_mse_gauge"] = u_reg
    return loss, metrics
