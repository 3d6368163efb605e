"""OneGNN: per-row dual predictor with sparse top-k refinement (torch.nn).

Port of ``lapgnn_tpu/models/one_gnn.py`` (``OneGNN`` :63, ``ResidualBlock``
:47, ``_global_context`` :136, ``_topk_smallest_iter`` :30).  A residual MLP
stack over the 21-D row features predicts row duals u; the top-k smallest
reduced costs of each row feed an attention-weighted edge-MLP message;
``context=True`` mixes a masked mean and max pool over the rows back into
every row.  Exact GELU and LayerNorm eps 1e-5, as in the flax model.

The submodules follow the original PyTorch OneGNN's layout (``input_proj``
= Linear, GELU, LayerNorm; ``row_out`` = Linear, GELU, Dropout, Linear;
``edge_mlp`` = Linear, GELU, Linear), so its state dicts load directly and
``lapgnn_tpu/train/convert_torch.py`` maps them to the flax tree; the flax
names are given beside each attribute.  ``train.convert.params_from_flax``
and ``params_to_flax`` convert between the two.

Dropout runs where the flax model's ``deterministic=False`` runs it (twice in
each block, on the top-k message, in the head), and only when the caller
passes a ``torch.Generator`` (``forward(..., generator=g)``): the masks are
drawn from it, never from the global RNG, as flax draws them from the
``dropout`` key; flax's own bits cannot be reproduced.  Without a generator
the forward is deterministic (flax's ``deterministic=True``), whatever the
module's ``training`` flag says.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .. import tracing
from ..ops.dual import center_gauge

__all__ = ["OneGNN", "ResidualBlock", "dropout"]

_LN_EPS = 1e-5
_TOPK_IMPLS = ("top_k", "iter")


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """flax ``nn.Dropout``: keep an entry with probability ``1 - rate`` (a
    uniform draw below it) and scale it by ``1 / (1 - rate)``; the identity
    without a generator or at rate 0, zeros at rate 1."""
    if generator is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


class ResidualBlock(nn.Module):
    """Post-LN residual MLP block (flax ``block_{i}``: fc1, fc2, norm)."""

    def __init__(self, hidden: int, dropout: float = 0.1):
        super().__init__()
        self.fc1 = nn.Linear(hidden, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.norm = nn.LayerNorm(hidden, eps=_LN_EPS)
        self.dropout = dropout

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        y = dropout(nn.functional.gelu(self.fc1(x), approximate="none"), self.dropout, generator)
        y = dropout(self.fc2(y), self.dropout, generator)
        return self.norm(x + y)


def _topk_smallest_iter(reduced: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest values of each row, ascending, duplicates kept: k
    rounds of argmin (the first index of a tie, as ``jnp.argmin``), each
    taking its value and setting its entry to +inf.  Equal to the values of
    ``torch.topk(-reduced, k)``, negated."""
    r = reduced
    values = []
    for _ in range(k):
        j = torch.argmin(r, dim=-1, keepdim=True)
        values.append(torch.gather(r, -1, j)[..., 0])
        r = r.scatter(-1, j, torch.inf)
    return torch.stack(values, dim=-1)


class OneGNN(nn.Module):
    """Row-dual predictor.

    ``forward(row_feat, cost=None, generator=None, mask=None)``: row_feat
    (B, n, F) or (n, F); cost (B, n, n) activates the top-k refinement; a
    generator turns dropout on; mask (B, n) or (n,) bool marks the valid
    rows.  Returns {"u": (B, n)}, mean-centered per instance (over every
    row, as flax's), masked rows 0.

    ``context=True`` adds the DeepSets global context (flax ``ctx_fc1``,
    ``ctx_fc2``, ``ctx_norm``).

    Only the gauge (the mean of u) and the context pool read other rows.
    When the rows are one rank's block of a row-sharded instance,
    ``row_reduce(t, op)`` combines a partial reduction ``t`` over the rows
    of every rank (``op`` "sum" or "max"); the gauge and the pools are then
    taken over every row.  Under autograd the combined value is handed back
    to this rank's rows, so its gradient is the SUM of the ranks'
    (``parallel.sharded.ShardedRows.reduce``).  ``topk_impl="iter"`` takes the top k by k
    rounds of argmin instead of ``torch.topk`` (the JAX package's form for a
    row-sharded cost); the values, and so the output, are the same.
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
        if topk_impl not in _TOPK_IMPLS:
            raise ValueError(f"topk_impl must be one of {_TOPK_IMPLS}, got {topk_impl!r}")
        self.hidden = hidden
        self.layers = layers
        self.dropout = dropout
        self.topk = topk
        self.context = context
        self.topk_impl = topk_impl
        head_hidden = max(hidden // 2, 1)
        # flax: input_proj (Dense) + input_norm (LayerNorm)
        self.input_proj = nn.Sequential(
            nn.Linear(in_dim, hidden), nn.GELU(approximate="none"),
            nn.LayerNorm(hidden, eps=_LN_EPS),
        )
        if context:
            # flax: ctx_fc1, ctx_fc2, ctx_norm
            self.ctx_fc1 = nn.Linear(2 * hidden, hidden)
            self.ctx_fc2 = nn.Linear(hidden, hidden)
            self.ctx_norm = nn.LayerNorm(hidden, eps=_LN_EPS)
        # flax: block_0 .. block_{layers-1}
        self.blocks = nn.ModuleList(ResidualBlock(hidden, dropout) for _ in range(layers))
        # flax: pre_out
        self.pre_out = nn.Linear(hidden, 1)
        # flax: head_fc1, head_fc2; the head's dropout (index 2) is applied
        # in ``forward`` with the caller's generator
        self.row_out = nn.Sequential(
            nn.Linear(hidden, head_hidden), nn.GELU(approximate="none"),
            nn.Identity(), nn.Linear(head_hidden, 1),
        )
        # flax: edge_fc1, edge_fc2
        self.edge_mlp = nn.Sequential(
            nn.Linear(1, hidden), nn.GELU(approximate="none"), nn.Linear(hidden, hidden),
        )
        # flax: message_norm
        self.message_norm = nn.LayerNorm(hidden, eps=_LN_EPS)

    def forward(
        self,
        row_feat: torch.Tensor,
        cost: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        mask: Optional[torch.Tensor] = None,
        row_reduce: Optional[Callable[[torch.Tensor, str], torch.Tensor]] = None,
    ) -> dict:
        if row_feat.ndim == 2:
            row_feat = row_feat[None]
        if mask is not None and mask.ndim == 1:
            mask = mask[None]
        h = self.input_proj(row_feat)
        if self.context:
            h = self._global_context(h, mask, row_reduce)
        for block in self.blocks:
            h = block(h, generator)
        u_pre = self.pre_out(h)[..., 0]
        if cost is not None:
            h = h + self._sparse_refine(h, cost, u_pre, generator, mask)
        head_fc1, gelu, _, head_fc2 = self.row_out
        y = dropout(gelu(head_fc1(h)), self.dropout, generator)
        u = head_fc2(y)[..., 0]
        if row_reduce is None:
            u = center_gauge(u)
        else:
            if mask is not None:
                raise ValueError("row_reduce takes no mask")
            rows = row_reduce(torch.full_like(u[..., :1], u.shape[-1]), "sum")
            u = u - row_reduce(u.sum(-1, keepdim=True), "sum") / rows
        if mask is not None:
            u = torch.where(mask, u, 0.0)
        return {"u": u}

    def _global_context(
        self,
        h: torch.Tensor,
        mask: Optional[torch.Tensor],
        row_reduce: Optional[Callable[[torch.Tensor, str], torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Masked mean and max pool over the rows, an MLP, added back to
        every row under a LayerNorm.  Masked rows move neither pool, so a
        padded batch gets the unpadded instance's context."""
        if row_reduce is not None:
            if mask is not None:
                raise ValueError("row_reduce takes no mask")
            rows = row_reduce(torch.full_like(h[..., 0, :1], h.shape[-2]), "sum")
            mean = row_reduce(h.sum(-2), "sum") / rows
            mx = row_reduce(h.amax(-2), "max")
        elif mask is not None:
            m = mask[..., None]  # (B, n, 1)
            cnt = torch.clamp_min(m.sum(-2).to(h.dtype), 1.0)
            mean = torch.where(m, h, 0.0).sum(-2) / cnt
            mx = torch.where(m, h, -torch.inf).amax(-2)
            mx = torch.where(torch.isfinite(mx), mx, 0.0)
        else:
            mean = h.mean(-2)
            mx = h.amax(-2)
        g = self.ctx_fc1(torch.cat([mean, mx], dim=-1))  # (B, 2H) -> (B, H)
        g = self.ctx_fc2(nn.functional.gelu(g, approximate="none"))
        return self.ctx_norm(h + g[..., None, :])

    def _sparse_refine(
        self,
        h: torch.Tensor,
        cost: torch.Tensor,
        u_pre: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Top-k smallest reduced-cost aggregation: softmax of the negated
        k smallest entries of (C - u_pre) weights an edge-MLP embedding of
        those values.  A masked row's reduced costs are +inf, its message 0.
        The tracer's span ``lapgnn.one.refine``."""
        k = min(self.topk, cost.shape[-1])
        if k <= 0 or h.shape[-2] == 0:
            return torch.zeros_like(h)
        with tracing.span("one.refine", cost.device):
            reduced = cost - u_pre[..., :, None]
            if mask is not None:
                reduced = torch.where(mask[..., :, None], reduced, torch.inf)
            # Only the values of the top k are used, never their indices, so the
            # order in which ties come out (lax.top_k's versus torch.topk's) does
            # not change the result.
            if self.topk_impl == "iter":
                values = _topk_smallest_iter(reduced, k)  # (B, n, k) ascending
                neg_vals = -values
            else:
                neg_vals = torch.topk(-reduced, k, dim=-1).values  # (B, n, k)
                values = -neg_vals
            valid = torch.isfinite(values)
            scores = torch.where(valid, neg_vals, -torch.inf)
            weights = torch.where(valid, torch.softmax(scores, dim=-1), 0.0)
            edge_in = torch.where(valid, values, 0.0)[..., None]  # (B, n, k, 1)
            e = self.edge_mlp(edge_in)  # (B, n, k, H)
            message = (weights[..., None] * e).sum(-2)
            if mask is not None:
                message = message * mask[..., :, None]
            return self.message_norm(dropout(message, self.dropout, generator))
