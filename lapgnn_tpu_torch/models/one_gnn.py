"""OneGNN: per-row dual predictor with sparse top-k refinement (torch.nn).

Port of ``lapgnn_tpu/models/one_gnn.py`` (``OneGNN`` :63, ``ResidualBlock``
:47).  A residual MLP stack over the 21-D row features predicts row duals u;
the top-k smallest reduced costs of each row feed an attention-weighted
edge-MLP message.  Exact GELU and LayerNorm eps 1e-5, as in the flax model.

The submodules follow the original PyTorch OneGNN's layout (``input_proj``
= Linear, GELU, LayerNorm; ``row_out`` = Linear, GELU, Dropout, Linear;
``edge_mlp`` = Linear, GELU, Linear), so its state dicts load directly and
``lapgnn_tpu/train/convert_torch.py`` maps them to the flax tree; the flax
names are given beside each attribute.  ``train.convert.params_from_flax``
is the inverse map.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.dual import center_gauge

__all__ = ["OneGNN", "ResidualBlock"]

_LN_EPS = 1e-5


class ResidualBlock(nn.Module):
    """Post-LN residual MLP block (flax ``block_{i}``: fc1, fc2, norm)."""

    def __init__(self, hidden: int, dropout: float = 0.1):
        super().__init__()
        self.fc1 = nn.Linear(hidden, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.norm = nn.LayerNorm(hidden, eps=_LN_EPS)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.drop(nn.functional.gelu(self.fc1(x), approximate="none"))
        y = self.drop(self.fc2(y))
        return self.norm(x + y)


class OneGNN(nn.Module):
    """Row-dual predictor.

    ``forward(row_feat, cost=None)``: row_feat (B, n, F) or (n, F); cost
    (B, n, n) activates the top-k refinement.  Returns {"u": (B, n)},
    mean-centered per instance.

    ``context=True`` (the DeepSets global context) and ``topk_impl="iter"``
    (the sharded top-k) are not ported yet; ``artifacts/one_gnn_default``
    uses neither.
    """

    def __init__(
        self,
        in_dim: int = 21,
        hidden: int = 64,
        layers: int = 2,
        dropout: float = 0.1,
        topk: int = 16,
        context: bool = False,
        topk_impl: str = "top_k",
    ):
        super().__init__()
        if context:
            raise NotImplementedError(
                "OneGNN(context=True) is not ported yet (see ROADMAP.md)"
            )
        if topk_impl != "top_k":
            raise NotImplementedError(
                f"OneGNN(topk_impl={topk_impl!r}) is not ported yet; only 'top_k'"
            )
        self.hidden = hidden
        self.layers = layers
        self.topk = topk
        head_hidden = max(hidden // 2, 1)
        # flax: input_proj (Dense) + input_norm (LayerNorm)
        self.input_proj = nn.Sequential(
            nn.Linear(in_dim, hidden), nn.GELU(approximate="none"),
            nn.LayerNorm(hidden, eps=_LN_EPS),
        )
        # flax: block_0 .. block_{layers-1}
        self.blocks = nn.ModuleList(ResidualBlock(hidden, dropout) for _ in range(layers))
        # flax: pre_out
        self.pre_out = nn.Linear(hidden, 1)
        # flax: head_fc1, head_fc2
        self.row_out = nn.Sequential(
            nn.Linear(hidden, head_hidden), nn.GELU(approximate="none"),
            nn.Dropout(dropout), nn.Linear(head_hidden, 1),
        )
        # flax: edge_fc1, edge_fc2
        self.edge_mlp = nn.Sequential(
            nn.Linear(1, hidden), nn.GELU(approximate="none"), nn.Linear(hidden, hidden),
        )
        # flax: message_norm
        self.message_norm = nn.LayerNorm(hidden, eps=_LN_EPS)
        self.message_drop = nn.Dropout(dropout)

    def forward(
        self, row_feat: torch.Tensor, cost: Optional[torch.Tensor] = None
    ) -> dict:
        if row_feat.ndim == 2:
            row_feat = row_feat[None]
        h = self.input_proj(row_feat)
        for block in self.blocks:
            h = block(h)
        u_pre = self.pre_out(h)[..., 0]
        if cost is not None:
            h = h + self._sparse_refine(h, cost, u_pre)
        u = self.row_out(h)[..., 0]
        return {"u": center_gauge(u)}

    def _sparse_refine(
        self, h: torch.Tensor, cost: torch.Tensor, u_pre: torch.Tensor
    ) -> torch.Tensor:
        """Top-k smallest reduced-cost aggregation: softmax of the negated
        k smallest entries of (C - u_pre) weights an edge-MLP embedding of
        those values."""
        k = min(self.topk, cost.shape[-1])
        if k <= 0 or h.shape[-2] == 0:
            return torch.zeros_like(h)
        reduced = cost - u_pre[..., :, None]
        # Only the values of the top k are used, never their indices, so the
        # order in which ties come out (lax.top_k's versus torch.topk's) does
        # not change the result.
        neg_vals = torch.topk(-reduced, k, dim=-1).values  # (B, n, k)
        values = -neg_vals
        valid = torch.isfinite(values)
        scores = torch.where(valid, neg_vals, -torch.inf)
        weights = torch.where(valid, torch.softmax(scores, dim=-1), 0.0)
        edge_in = torch.where(valid, values, 0.0)[..., None]  # (B, n, k, 1)
        e = self.edge_mlp(edge_in)  # (B, n, k, H)
        message = (weights[..., None] * e).sum(-2)
        return self.message_norm(self.message_drop(message))
