"""Feature engineering for OneGNN and DualGNN, batched in PyTorch.

Port of ``lapgnn_tpu/ops/features.py``.  The 21-D OneGNN row features:
``row_features`` (the sort-based form, an independent reference for kernel
K3) and the router ``fast_row_features``, which the predict path calls.
Channels, in order: row min, max, mean, std (population), MAD, entropy,
second-best gap, competition, k=10-smallest mean/std, difficulty, near-best
density, is-col-best fraction, then 8-D positional encodings.

DualGNN's dense bipartite features, ``graph_features``: 14-D node features
for rows and columns and a 10-channel (n, n) edge tensor.  The router
``graph_features`` sends a whole CUDA matrix to two hand-written kernels
(``ops/cuda/graph_features.py``); every other call takes the sort-based
``graph_features_plain``, as in the JAX package, which has no Pallas kernel
for them.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .cuda.features import row_features_max_m, row_features_stats
from .cuda.graph_features import graph_features as _graph_features_kernel
from .cuda.graph_features import MAX_BATCH, graph_features_max_len

__all__ = [
    "POS_FREQS",
    "TAU",
    "EPS",
    "ROW_FEATURE_DIM",
    "NODE_FEATURE_DIM",
    "EDGE_FEATURE_DIM",
    "positional_encodings",
    "row_features",
    "fast_row_features",
    "graph_features",
    "graph_features_plain",
    "GraphFeatures",
]

POS_FREQS = (1, 2, 4, 8)  # doubling from 1: positional_encodings makes them so
TAU = 1e-3
EPS = 1e-9
ROW_FEATURE_DIM = 13 + 2 * len(POS_FREQS)  # 21
NODE_FEATURE_DIM = 6 + 2 * len(POS_FREQS)  # 14
EDGE_FEATURE_DIM = 10


def positional_encodings(n: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """sin/cos of 2*pi*pos*f/max(1, n-1) for f in (1, 2, 4, 8) -> (n, 8).
    The frequencies double from 1, so they are made where they are used,
    as integer powers of two: no copy from the host."""
    pos = torch.arange(n, dtype=torch.float32, device=device).reshape(n, 1)
    scale = float(max(1, n - 1))
    freqs = torch.pow(2, torch.arange(len(POS_FREQS), device=device)).to(torch.float32)
    freqs = freqs.reshape(1, -1)
    angle = 2.0 * math.pi * pos * freqs / scale
    enc = torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1)
    return enc.reshape(n, 2 * len(POS_FREQS)).to(dtype)


def _median_from_sorted(sorted_vals: torch.Tensor) -> torch.Tensor:
    m = sorted_vals.shape[-1]
    mid = m // 2
    if m % 2 == 1:
        return sorted_vals[..., mid]
    return 0.5 * (sorted_vals[..., mid - 1] + sorted_vals[..., mid])


def _kth_of_merged(A: torch.Tensor, B: torch.Tensor, k: int) -> torch.Tensor:
    """Rank-k (0-indexed) element of merge(A, B) along the last axis, A and B
    each sorted ascending: bisection over how many elements come from A."""
    p, q = A.shape[-1], B.shape[-1]
    lead = A.shape[:-1]
    neg = torch.full(lead + (1,), -torch.inf, dtype=A.dtype, device=A.device)
    pos = torch.full(lead + (1,), torch.inf, dtype=A.dtype, device=A.device)
    Ap = torch.cat([neg, A, pos], dim=-1)  # Ap[i] == A[i-1] with sentinels
    Bp = torch.cat([neg, B, pos], dim=-1)

    lo0 = max(0, k + 1 - q)
    hi0 = min(k + 1, p)
    lo = torch.full(lead, lo0, dtype=torch.int64, device=A.device)
    hi = torch.full(lead, hi0, dtype=torch.int64, device=A.device)

    def take(X, idx):
        return torch.gather(X, -1, idx[..., None])[..., 0]

    steps = max(1, int(np.ceil(np.log2(max(2, hi0 - lo0 + 1)))) + 1)
    for _ in range(steps):
        i = torch.div(lo + hi, 2, rounding_mode="floor")
        j = k + 1 - i
        need_less_from_A = take(Ap, i) > take(Bp, j + 1)
        hi = torch.where(need_less_from_A, i - 1, hi)
        need_more_from_A = take(Bp, j) > take(Ap, i + 1)
        lo = torch.where(
            need_less_from_A, lo, torch.where(need_more_from_A, i + 1, i)
        )
        hi = torch.where(
            need_less_from_A, hi, torch.where(need_more_from_A, hi, i)
        )
    j = k + 1 - lo
    return torch.maximum(take(Ap, lo), take(Bp, j))


def _mad_from_sorted(sorted_vals: torch.Tensor, med: torch.Tensor) -> torch.Tensor:
    """MAD from the sorted row: sorted |x - med| is the merge of two sorted
    halves, so an exact selection replaces a second sort."""
    m = sorted_vals.shape[-1]
    mid = m // 2
    A = med[..., None] - sorted_vals[..., :mid].flip(-1)
    B = sorted_vals[..., mid:] - med[..., None]
    if m % 2 == 1:
        return _kth_of_merged(A, B, mid)
    return 0.5 * (_kth_of_merged(A, B, mid - 1) + _kth_of_merged(A, B, mid))


def _entropy(C: torch.Tensor, dim: int) -> torch.Tensor:
    """Min-shifted softmax entropy of exp(-C) along ``dim``."""
    Z = C.amin(dim, keepdim=True)
    e = torch.exp(-(C - Z))
    p = e / (e.sum(dim, keepdim=True) + EPS)
    return -(p * torch.log(p + EPS)).sum(dim)


def row_features(
    C: torch.Tensor,
    col_min: Optional[torch.Tensor] = None,
    pos: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sort-based 21-D row features: (n, m) -> (n, 21), (B, n, m) -> (B, n, 21).

    Every channel but two reads only its own row.  When C is one rank's block
    of a row-sharded matrix, the caller passes what the other two need from
    the whole matrix: ``col_min``, the column minima of every row ((B, m) or
    (m,)), for the is-col-best channel, and ``pos``, the positional
    encodings of the block's global rows ((n, 8))."""
    squeeze = C.ndim == 2
    if squeeze:
        C = C[None]
    B, n, m = C.shape
    Cf = C.to(torch.float32)

    row_min = Cf.amin(-1)
    row_max = Cf.amax(-1)
    row_mean = Cf.mean(-1)
    row_std = Cf.std(-1, correction=0)

    sorted_C = torch.sort(Cf, dim=-1).values
    row_med = _median_from_sorted(sorted_C)
    row_mad = torch.clamp_min(_mad_from_sorted(sorted_C, row_med), EPS)
    row_entropy = _entropy(Cf, dim=-1)

    zeros = torch.zeros((B, n), dtype=torch.float32, device=C.device)
    if m >= 2:
        second_best_gap = sorted_C[..., 1] - sorted_C[..., 0]
        span = sorted_C[..., -1] - sorted_C[..., 0]
        competition = second_best_gap / (span + EPS)
        diffs = sorted_C[..., 1:] - sorted_C[..., :-1]
        difficulty = 1.0 / (diffs.mean(-1) + EPS)
    else:
        second_best_gap = competition = difficulty = zeros

    k = min(10, m)
    k_small = sorted_C[..., :k]
    k_mean = k_small.mean(-1)
    k_std = k_small.std(-1, correction=0)

    near_best = (Cf <= row_min[..., None] * 1.1).to(torch.float32).mean(-1)
    col_min = Cf.amin(-2) if col_min is None else col_min.to(torch.float32).expand(B, m)
    is_col_best = (Cf == col_min[..., None, :]).to(torch.float32).sum(-1) / m

    if pos is None:
        pos = positional_encodings(n, device=C.device)
    pos = pos.expand(B, n, 2 * len(POS_FREQS))
    stats = torch.stack(
        [row_min, row_max, row_mean, row_std, row_mad, row_entropy,
         second_best_gap, competition, k_mean, k_std, difficulty,
         near_best, is_col_best],
        dim=-1,
    )
    feat = torch.cat([stats, pos], dim=-1)
    return feat[0] if squeeze else feat


def fast_row_features(C: torch.Tensor) -> torch.Tensor:
    """21-D row features with the statistics from kernel K3 (which runs K1
    inside) on a CUDA tensor; a CPU tensor takes K3's plain version.  Rows
    longer than K3 takes on this device (``row_features_max_m``: its
    shared-memory path's limit, about 58K columns on an H100) go to the
    sort-based ``row_features``, as the JAX router sends every shape outside
    its gate there.  The TPU router's other size gates and its opt-out switch
    are dropped: they were measured on a TPU, and the port has no switch that
    turns a kernel off."""
    if C.shape[-1] > row_features_max_m(C.device):
        return row_features(C)
    squeeze = C.ndim == 2
    Cb = (C[None] if squeeze else C).contiguous()
    B, n, _ = Cb.shape
    stats = row_features_stats(Cb)
    pos = positional_encodings(n, device=C.device).expand(B, n, 2 * len(POS_FREQS))
    feat = torch.cat([stats, pos], dim=-1)
    return feat[0] if squeeze else feat


class GraphFeatures(NamedTuple):
    row_feat: torch.Tensor   # (..., n, 14)
    col_feat: torch.Tensor   # (..., n, 14)
    edge_feat: torch.Tensor  # (..., n, n, 10)


def _normalized_ranks(C: torch.Tensor, dim: int) -> torch.Tensor:
    """Rank of each entry along ``dim``, normalised to [0, 1].  The order is
    a stable argsort, as ``jnp.argsort``'s, so equal entries (the sparse
    family's many 1e6 sentinels) rank by position; the ranks are its inverse
    permutation, written by a scatter (JAX takes a second argsort, which
    gives the same permutation)."""
    n = C.shape[dim]
    if n <= 1:
        return torch.zeros_like(C, dtype=torch.float32)
    order = torch.argsort(C, dim=dim, stable=True)
    shape = [1] * C.ndim
    shape[dim] = n
    pos = torch.arange(n, device=C.device).view(shape).expand_as(order)
    ranks = torch.empty_like(order).scatter_(dim, order, pos)
    return _exact_div(ranks.to(torch.float32), n - 1)


def _exact_div(x: torch.Tensor, d: int) -> torch.Tensor:
    """x / d, rounded once.  With a Python number for d, PyTorch multiplies
    by its reciprocal on CUDA (one ulp apart from the division for most d);
    a tensor divisor keeps the division, as on the CPU and in JAX.  The
    divisor is filled in on x's device, with no copy from the host."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


def _axis_stats(C: torch.Tensor, dim: int):
    """min, max, mean, population std, median, MAD (floored at EPS) and the
    softmax entropy of C along ``dim``, from one sort."""
    mn = C.amin(dim)
    mx = C.amax(dim)
    mean = C.mean(dim)
    std = C.std(dim, correction=0)
    sorted_vals = torch.sort(C.movedim(dim, -1), dim=-1).values
    med = _median_from_sorted(sorted_vals)
    mad = torch.clamp_min(_mad_from_sorted(sorted_vals, med), EPS)
    ent = _entropy(C, dim=dim)
    return mn, mx, mean, std, med, mad, ent


def _on_card(C: torch.Tensor) -> bool:
    return C.device.type == "cuda"


def graph_features(
    C: torch.Tensor,
    include_reduced_cost: bool = False,
    u: Optional[torch.Tensor] = None,
    constrain_rows: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    constrain_cols: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    offsets: Tuple[int, int] = (0, 0),
) -> GraphFeatures:
    """Dense bipartite graph features for DualGNN (``graph_features_plain``
    says what they are), routed by what the call shows.  The kernels
    (``ops.cuda.graph_features``: a column pass and a row pass, no host
    copy) take a CUDA matrix that is the whole matrix (no hooks, offsets
    (0, 0)), with no reduced-cost channel to fill (``include_reduced_cost``
    off or ``u`` None) and rows and columns no longer than the kernels'
    shared memory holds (``graph_features_max_len``), and that needs no
    gradient (the kernels' outputs carry none).  Every other call, the CPU,
    ``parallel.dual``'s tiles, the reduced-cost channel, longer lines and a
    C that requires grad with grad mode on, takes the sort-based
    ``graph_features_plain``.  An admitted call whose launch fails raises."""
    if (_on_card(C) and not (C.requires_grad and torch.is_grad_enabled())
            and constrain_rows is None and constrain_cols is None
            and tuple(offsets) == (0, 0) and not (include_reduced_cost and u is not None)
            and C.ndim in (2, 3) and C.numel() > 0
            and (C.ndim == 2 or C.shape[0] <= MAX_BATCH)
            and max(C.shape[-2:]) <= graph_features_max_len(C.device)):
        return GraphFeatures(*_graph_features_kernel(C.to(torch.float32).contiguous()))
    return graph_features_plain(C, include_reduced_cost, u, constrain_rows, constrain_cols,
                                offsets)


def graph_features_plain(
    C: torch.Tensor,
    include_reduced_cost: bool = False,
    u: Optional[torch.Tensor] = None,
    constrain_rows: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    constrain_cols: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    offsets: Tuple[int, int] = (0, 0),
) -> GraphFeatures:
    """Dense bipartite graph features for DualGNN: (n, n) or (B, n, n).

    Node features (14-D, rows and columns alike): min, max, mean, std, MAD,
    entropy, then the 8-D positional encodings.  Edge channels (10): scaled
    cost (C - row median) / row MAD, row rank, column rank, row gap, column
    gap, row / column tie fractions (gap <= TAU), row / column entropies
    (broadcast), and the reduced cost against ``u`` and its min-trick v when
    ``include_reduced_cost`` and ``u`` are given (zeros otherwise).

    ``constrain_rows`` / ``constrain_cols`` are the JAX function's sharding
    hooks, the identity on one device.  When C is a tile of the matrix (a
    block of its rows and of its columns, at ``offsets``: its first row and
    column), ``constrain_rows(C)`` returns every column of the tile's rows
    and ``constrain_cols(C)`` every row of its columns (``parallel.dual``
    gathers them); the row and column statistics read those, and the
    features returned are the tile's: its rows', its columns' and its
    entries'.  Memory: the edge tensor is B·n²·10 float32, 160 MiB at
    n = 2048."""
    squeeze = C.ndim == 2
    if squeeze:
        C = C[None]
    B, n, m = C.shape
    Cf = C.to(torch.float32)
    Cr = constrain_rows(Cf) if constrain_rows is not None else Cf
    Cc = constrain_cols(Cf) if constrain_cols is not None else Cf
    row0, col0 = offsets
    n_cols, n_rows = Cr.shape[-1], Cc.shape[-2]

    r_mn, r_mx, r_mean, r_std, r_med, r_mad, r_ent = _axis_stats(Cr, dim=-1)
    c_mn, c_mx, c_mean, c_std, c_med, c_mad, c_ent = _axis_stats(Cc, dim=-2)

    scaled_cost = (Cf - r_med[..., :, None]) / r_mad[..., :, None]
    row_rank = _normalized_ranks(Cr, dim=-1).narrow(-1, col0, m)
    col_rank = _normalized_ranks(Cc, dim=-2).narrow(-2, row0, n)
    row_gap = Cf - r_mn[..., :, None]
    col_gap = Cf - c_mn[..., None, :]
    row_tie = _exact_div(((Cr - r_mn[..., :, None]) <= TAU).to(torch.float32).sum(-1), max(1, n_cols))
    col_tie = _exact_div(((Cc - c_mn[..., None, :]) <= TAU).to(torch.float32).sum(-2), max(1, n_rows))

    if include_reduced_cost and u is not None:
        if (n, m) != (n_rows, n_cols):
            raise ValueError("the reduced-cost channel needs the whole matrix, not a tile")
        uf = u.to(torch.float32)
        if uf.ndim == 1:
            uf = uf[None]
        v = (Cf - uf[..., :, None]).amin(-2)
        reduced = Cf - uf[..., :, None] - v[..., None, :]
    else:
        reduced = torch.zeros_like(Cf)

    edge_feat = torch.stack(
        [
            scaled_cost,
            row_rank,
            col_rank,
            row_gap,
            col_gap,
            row_tie[..., :, None].expand(B, n, m),
            col_tie[..., None, :].expand(B, n, m),
            r_ent[..., :, None].expand(B, n, m),
            c_ent[..., None, :].expand(B, n, m),
            reduced,
        ],
        dim=-1,
    )

    width = 2 * len(POS_FREQS)
    row_pos = positional_encodings(n_rows, device=C.device)[row0 : row0 + n].expand(B, n, width)
    col_pos = positional_encodings(n_cols, device=C.device)[col0 : col0 + m].expand(B, m, width)
    row_feat = torch.cat(
        [torch.stack([r_mn, r_mx, r_mean, r_std, r_mad, r_ent], dim=-1), row_pos], dim=-1
    )
    col_feat = torch.cat(
        [torch.stack([c_mn, c_mx, c_mean, c_std, c_mad, c_ent], dim=-1), col_pos], dim=-1
    )
    if squeeze:
        return GraphFeatures(row_feat[0], col_feat[0], edge_feat[0])
    return GraphFeatures(row_feat, col_feat, edge_feat)
