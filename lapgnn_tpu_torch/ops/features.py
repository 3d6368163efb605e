"""21-D OneGNN row features, batched in PyTorch.

Port of the row path of ``lapgnn_tpu/ops/features.py``: ``row_features``
(the sort-based form, an independent reference for kernel K3) and the router
``fast_row_features``, which the predict path calls.  Channels, in order: row
min, max, mean, std (population), MAD, entropy, second-best gap,
competition, k=10-smallest mean/std, difficulty, near-best density,
is-col-best fraction, then 8-D positional encodings.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .cuda.features import row_features_stats

__all__ = [
    "POS_FREQS",
    "EPS",
    "ROW_FEATURE_DIM",
    "positional_encodings",
    "row_features",
    "fast_row_features",
]

POS_FREQS = (1, 2, 4, 8)
EPS = 1e-9
ROW_FEATURE_DIM = 13 + 2 * len(POS_FREQS)  # 21


def positional_encodings(n: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """sin/cos of 2*pi*pos*f/max(1, n-1) for f in (1, 2, 4, 8) -> (n, 8)."""
    pos = torch.arange(n, dtype=torch.float32, device=device).reshape(n, 1)
    scale = float(max(1, n - 1))
    freqs = torch.tensor(POS_FREQS, dtype=torch.float32, device=device).reshape(1, -1)
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


def row_features(C: torch.Tensor) -> torch.Tensor:
    """Sort-based 21-D row features: (n, m) -> (n, 21), (B, n, m) -> (B, n, 21)."""
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
    col_min = Cf.amin(-2)
    is_col_best = (Cf == col_min[..., None, :]).to(torch.float32).sum(-1) / m

    pos = positional_encodings(n, device=C.device).expand(B, n, 2 * len(POS_FREQS))
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
    inside) on a CUDA tensor, at every n; a CPU tensor takes K3's plain
    version.  The TPU router's size gates and its opt-out switch are dropped:
    they were measured on a TPU, and the port has no switch that turns a
    kernel off."""
    squeeze = C.ndim == 2
    Cb = (C[None] if squeeze else C).contiguous()
    B, n, _ = Cb.shape
    stats = row_features_stats(Cb)
    pos = positional_encodings(n, device=C.device).expand(B, n, 2 * len(POS_FREQS))
    feat = torch.cat([stats, pos], dim=-1)
    return feat[0] if squeeze else feat
