"""DualGNN: bipartite attention dual predictor (torch.nn).

Port of ``lapgnn_tpu/models/dual_gnn.py`` (``DualLayer`` :29, ``DualGNN``
:146).  Row and column embeddings exchange messages through multi-head
attention over the dense (n, n) edge tensor, in both directions, each round
followed by a residual update and LayerNorm (eps 1e-5); exact GELU
throughout.  As in the flax model, each direction's attention weight is
split into (receiver, sender, edge) thirds of shape (heads, 3, head_dim), so
the score is  leaky_relu_0.2(<w_r, recv_i> + <w_s, send_j> + <w_e, e_ij> + b).

The edge MLP's output e (B, n, n, hidden) is only read through the two edge
terms.  Both are taken in one matrix product of ``e.view(-1, hidden)`` with a
block-diagonal (hidden, 2·heads) matrix, so e is read once and never
permuted or copied (at n = 2048 and hidden 256 it is 4 GiB); the column
direction reads its half transposed, a view.

Attribute names follow the flax tree (``row_encoder_fc`` … ``layer.{i}`` for
``layer_{i}`` … ``col_out``); ``train.convert`` maps the parameters both
ways.  Dropout runs only when the caller passes a ``torch.Generator``, as in
``models.one_gnn``; each layer draws its masks from a generator seeded by one
draw from the caller's, so a rematerialised layer redraws the same masks.
The input widths are the features': 14 a node, 10 an edge.

Each layer is two spans of the tracer (``tracing``): ``lapgnn.dual.edge``,
the edge MLP and the two edge terms, and ``lapgnn.dual.attention``, the node
projections, both attention directions and the node updates.  Each
``DualGNN.forward`` call adds one to the always-on counter ``dual_forward``.

``forward(..., part=...)`` runs the model on one tile of a 2-D edge
partition (``parallel.dual.EdgeTiles``): the edge features of a block of
rows and a block of columns, the node features of those rows and columns.
Row embeddings then live with their row block and column embeddings with
their column block; the edge activations never leave the tile.  Each
attention direction contracts over the axis that is split: a row's
softmax maximum and sum, and its message, are the tile's partial ones
combined over the column blocks (``part.over_cols``), a column's over the
row blocks; the gauge mean of u is a sum over the row blocks.  A node
vector that enters the tile's computation goes through ``part.vary_*``, so
its gradient is summed over the tiles that read it.  Dropout then draws
the edge masks per tile and the row (column) masks per row (column) block,
so that every tile of one row block computes its rows alike.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from .. import tracing
from ..ops.features import EDGE_FEATURE_DIM, NODE_FEATURE_DIM
from .one_gnn import dropout

__all__ = ["DualGNN", "DualLayer", "attention_init_"]

_LN_EPS = 1e-5
_EDGE_HIDDEN = 128


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def attention_init_(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> None:
    """flax's ``xavier_uniform`` on a (heads, 3, head_dim) attention weight:
    fan_in = 3·heads and fan_out = head_dim·heads (flax reads the last two
    axes as in and out and the first as the receptive field), so the limit
    is sqrt(6 / (3·heads + head_dim·heads)).  ``nn.init.xavier_uniform_``
    reads the first two axes and would take 3·head_dim and heads·head_dim."""
    heads, three, head_dim = weight.shape
    limit = (6.0 / (three * heads + head_dim * heads)) ** 0.5
    with torch.no_grad():
        weight.uniform_(-limit, limit, generator=generator)


class DualLayer(nn.Module):
    """One bidirectional attention round (flax ``layer_{i}``)."""

    def __init__(self, hidden_dim: int, heads: int = 4, dropout: float = 0.1):
        super().__init__()
        if hidden_dim % heads != 0:
            raise ValueError("hidden_dim must be divisible by heads")
        self.hidden_dim = hidden_dim
        self.heads = heads
        self.head_dim = hidden_dim // heads
        self.dropout = dropout
        self.row_proj = nn.Linear(hidden_dim, hidden_dim, bias=False)
        self.col_proj = nn.Linear(hidden_dim, hidden_dim, bias=False)
        self.row_val = nn.Linear(hidden_dim, hidden_dim, bias=False)
        self.col_val = nn.Linear(hidden_dim, hidden_dim, bias=False)
        self.attn_row = nn.Parameter(torch.empty(heads, 3, self.head_dim))
        self.attn_col = nn.Parameter(torch.empty(heads, 3, self.head_dim))
        self.attn_row_bias = nn.Parameter(torch.zeros(heads))
        self.attn_col_bias = nn.Parameter(torch.zeros(heads))
        attention_init_(self.attn_row)
        attention_init_(self.attn_col)
        self.edge_fc1 = nn.Linear(EDGE_FEATURE_DIM, _EDGE_HIDDEN)
        self.edge_fc2 = nn.Linear(_EDGE_HIDDEN, _EDGE_HIDDEN)
        self.edge_fc3 = nn.Linear(_EDGE_HIDDEN, hidden_dim)
        self.row_update = nn.Linear(2 * hidden_dim, hidden_dim)
        self.col_update = nn.Linear(2 * hidden_dim, hidden_dim)
        self.row_norm = nn.LayerNorm(hidden_dim, eps=_LN_EPS)
        self.col_norm = nn.LayerNorm(hidden_dim, eps=_LN_EPS)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.view(x.shape[0], x.shape[1], self.heads, self.head_dim)

    def _edge_weight(self) -> torch.Tensor:
        """(hidden, 2·heads): column h holds attn_row[h, 2] in rows
        h·head_dim … (h+1)·head_dim − 1, column heads + h attn_col[h, 2]."""
        eye = torch.eye(self.heads, dtype=self.attn_row.dtype, device=self.attn_row.device)
        blocks = [(a[:, 2, :, None] * eye[:, None, :]).reshape(self.hidden_dim, self.heads)
                  for a in (self.attn_row, self.attn_col)]
        return torch.cat(blocks, dim=1)

    def _attention(self, src, dst, edge, bias, values, mask, generator):
        """Receiver i attends over senders j.  src, dst (B, n, H); edge
        (B, n, n, H); values (B, n, H, D) indexed by the sender."""
        score = dst[:, :, None, :] + src[:, None, :, :] + edge + bias
        score = F.leaky_relu(score, negative_slope=0.2)
        if mask is not None:
            score = score.masked_fill(~mask[:, :, None, None], -torch.inf)
            score = score.masked_fill(~mask[:, None, :, None], -torch.inf)
        w = torch.softmax(score, dim=2)
        w = torch.where(torch.isfinite(w), w, 0.0)
        w = dropout(w, self.dropout, generator)
        msg = torch.einsum("bijh,bjhd->bihd", w, values)
        return msg.reshape(msg.shape[0], msg.shape[1], self.hidden_dim)

    def _tile_attention(self, src, dst, edge, bias, values, generator, vary_recv, vary_send,
                        combine):
        """``_attention`` on a tile: the receivers' block against this
        tile's senders.  ``vary_recv`` hands a receiver vector to the tile,
        ``vary_send`` a sender vector; ``combine(t, op)`` joins the tile's
        partial results over the senders' blocks."""
        score = vary_recv(dst)[:, :, None, :] + vary_send(src)[:, None, :, :] + edge + bias
        score = F.leaky_relu(score, negative_slope=0.2)
        top = combine(score.detach().amax(2), "max")
        top = torch.where(torch.isfinite(top), top, 0.0)
        ex = torch.exp(score - top[:, :, None, :])
        w = ex / vary_recv(combine(ex.sum(2), "sum"))[:, :, None, :]
        w = torch.where(torch.isfinite(w), w, 0.0)
        w = dropout(w, self.dropout, generator)
        msg = combine(torch.einsum("bijh,bjhd->bihd", w, vary_send(values)), "sum")
        return msg.reshape(msg.shape[0], msg.shape[1], self.hidden_dim)

    def forward(
        self,
        edge_feat: torch.Tensor,
        row_embed: torch.Tensor,
        col_embed: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        seed: Optional[int] = None,
        part=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``seed`` seeds this layer's dropout masks; None runs it
        deterministically.  ``part``: the edge partition of a tile (no
        mask then)."""
        B, N, M = edge_feat.shape[:3]
        H = self.heads
        if seed is None:
            g_edge = g_row = g_col = None
        elif part is None:
            g_edge = g_row = g_col = torch.Generator(edge_feat.device).manual_seed(seed)
        else:
            if mask is not None:
                raise ValueError("a tile takes no mask")
            g_edge, g_row, g_col = (torch.Generator(edge_feat.device).manual_seed(s)
                                    for s in part.dropout_seeds(seed))
        dev = edge_feat.device
        with tracing.span("dual.edge", dev):
            # one name for every stage, so that each (B, N, M, ·) activation is
            # freed as soon as the next exists: at most two of them live at once
            e = dropout(_gelu(self.edge_fc1(edge_feat)), self.dropout, g_edge)
            e = self.edge_fc2(e)
            e = _gelu(e)
            e = self.edge_fc3(e)  # (B, N, M, hidden)
            edge_terms = torch.matmul(e.view(-1, self.hidden_dim), self._edge_weight())
            del e
            edge_terms = edge_terms.view(B, N, M, 2 * H)
            r_edge = edge_terms[..., :H]
            c_edge = edge_terms[..., H:].transpose(1, 2)  # "bijhd,hd->bjih"

        with tracing.span("dual.attention", dev):
            rp = self._heads(self.row_proj(row_embed))
            cp = self._heads(self.col_proj(col_embed))
            rv = self._heads(self.row_val(row_embed))
            cv = self._heads(self.col_val(col_embed))

            # rows receive from columns
            r_dst = (rp * self.attn_row[:, 0]).sum(-1)
            r_src = (cp * self.attn_row[:, 1]).sum(-1)
            # columns receive from rows, over the transposed edge term
            c_dst = (cp * self.attn_col[:, 0]).sum(-1)
            c_src = (rp * self.attn_col[:, 1]).sum(-1)
            if part is None:
                row_message = self._attention(
                    r_src, r_dst, r_edge, self.attn_row_bias, cv, mask, g_edge
                )
                col_message = self._attention(
                    c_src, c_dst, c_edge, self.attn_col_bias, rv, mask, g_edge
                )
            else:
                row_message = self._tile_attention(
                    r_src, r_dst, r_edge, self.attn_row_bias, cv, g_edge,
                    part.vary_cols, part.vary_rows, part.over_cols,
                )
                col_message = self._tile_attention(
                    c_src, c_dst, c_edge, self.attn_col_bias, rv, g_edge,
                    part.vary_rows, part.vary_cols, part.over_rows,
                )

            ru = dropout(_gelu(self.row_update(torch.cat([row_embed, row_message], -1))),
                         self.dropout, g_row)
            cu = dropout(_gelu(self.col_update(torch.cat([col_embed, col_message], -1))),
                         self.dropout, g_col)
            return self.row_norm(row_embed + ru), self.col_norm(col_embed + cu)


class DualGNN(nn.Module):
    """Bipartite dual predictor.

    ``forward(edge_feat (B, n, n, 10), row_feat (B, n, 14), col_feat
    (B, n, 14), mask (B, n) bool or None, generator=None)`` ->
    ``{"u": (B, n), "v_hint": (B, n)}``: u mean-centred, v_hint shifted by
    +mean(u) (the gauge moves to v); masked entries 0.

    ``remat=True`` recomputes each layer's O(n²·hidden) activations in the
    backward pass (``torch.utils.checkpoint``, non-reentrant) instead of
    storing them; the outputs are the same.  Under ``part`` the recomputed
    layer makes its collectives again, in the order of the forward, on
    every rank alike.

    ``part`` (a tile of ``parallel.dual.EdgeTiles``): the inputs are the
    tile's, and u comes back for its rows, v_hint for its columns.
    """

    def __init__(
        self,
        hidden_dim: int = 128,
        layers: int = 4,
        heads: int = 4,
        dropout: float = 0.1,
        remat: bool = False,
    ):
        super().__init__()
        if layers <= 0:
            # an encoder-only model would serve near-useless duals
            raise ValueError("DualGNN requires layers >= 1")
        self.hidden_dim = hidden_dim
        self.num_layers = layers
        self.heads = heads
        self.dropout = dropout
        self.remat = remat
        self.row_encoder_fc = nn.Linear(NODE_FEATURE_DIM, hidden_dim)
        self.row_encoder_norm = nn.LayerNorm(hidden_dim, eps=_LN_EPS)
        self.col_encoder_fc = nn.Linear(NODE_FEATURE_DIM, hidden_dim)
        self.col_encoder_norm = nn.LayerNorm(hidden_dim, eps=_LN_EPS)
        self.layer = nn.ModuleList(
            DualLayer(hidden_dim, heads, dropout) for _ in range(layers)
        )
        self.row_out = nn.Linear(hidden_dim, 1)
        self.col_out = nn.Linear(hidden_dim, 1)

    def forward(
        self,
        edge_feat: torch.Tensor,
        row_feat: torch.Tensor,
        col_feat: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        part=None,
    ) -> dict:
        if edge_feat.ndim != 4:
            raise ValueError("edge_feat must be (batch, n, n, F)")
        tracing.count("dual_forward")
        row_embed = self.row_encoder_norm(_gelu(self.row_encoder_fc(row_feat)))
        col_embed = self.col_encoder_norm(_gelu(self.col_encoder_fc(col_feat)))
        for layer in self.layer:
            seed = None
            if generator is not None and self.dropout > 0.0:
                draw = torch.randint(0, 2**62, (1,), generator=generator, device=generator.device)
                # a generator on the card makes the read a host sync
                seed = int(tracing.item(draw) if draw.device.type != "cpu" else draw.item())
            args = (edge_feat, row_embed, col_embed, mask, seed, part)
            if self.remat and torch.is_grad_enabled():
                row_embed, col_embed = checkpoint(layer, *args, use_reentrant=False)
            else:
                row_embed, col_embed = layer(*args)

        u = self.row_out(row_embed)[..., 0]
        v_hint = self.col_out(col_embed)[..., 0]
        if part is None:
            mean_u = u.mean(-1, keepdim=True)
            u = u - mean_u
            v_hint = v_hint + mean_u
        else:
            rows, _ = part.whole_shape(edge_feat[..., 0])
            mean_u = part.over_rows(u.sum(-1, keepdim=True)) / rows
            u = u - part.vary_rows(mean_u)
            v_hint = v_hint + part.vary_cols(mean_u)
        if mask is not None:
            u = torch.where(mask, u, 0.0)
            v_hint = torch.where(mask, v_hint, 0.0)
        return {"u": u, "v_hint": v_hint}
