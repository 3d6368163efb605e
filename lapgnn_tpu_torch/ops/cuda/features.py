"""K3 row-feature statistics: CUDA kernel and its plain version.

Replaces ``lapgnn_tpu/ops/pallas/features.py:pallas_row_features_stats``
(:193, body ``_feature_kernel`` :119): the 13 statistic channels of the 21-D
OneGNN row features (``STAT_CHANNELS``) in one read of C, with exact median,
MAD and k=10 selection by a 32-step bisection on order-isomorphic uint32 keys.

Bound on this card: arithmetic.  C is read once (``B*n*m*4`` bytes), but each
element is visited about a hundred times by the three bisections and the
moment passes.  Design (``csrc/features.cu``): one block per row, the row
staged once in dynamic shared memory (4*m bytes), keys recomputed from it on
every pass, one block-wide count per bisection step.  Rows longer than the
card's shared memory allows (m above about 58K on an H100) raise.

``row_features_stats_plain`` transcribes the JAX kernel body, bisection and
all, so it compares one to one with ``pallas_row_features_stats``; the
sort-based ``ops.features.row_features`` is a second, independent reference.
"""

from __future__ import annotations

import torch

from .colmin import col_min

__all__ = [
    "STAT_CHANNELS",
    "row_features_stats",
    "row_features_stats_plain",
]

EPS = 1e-9

STAT_CHANNELS = (
    "min", "max", "mean", "std", "mad", "entropy", "second_best_gap",
    "competition", "k_mean", "k_std", "difficulty", "near_best",
    "is_col_best",
)

# uint32 keys are held in int64: torch has no full set of unsigned ops.
_SIGN = 0x80000000
_FULL = 0xFFFFFFFF


def _to_key(x: torch.Tensor) -> torch.Tensor:
    """Order-isomorphic f32 -> uint32 (in int64): negatives bit-inverted,
    positives sign-flipped (``_to_key``).  +0.0 and -0.0 get different keys,
    exactly as in the JAX kernel."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & _FULL
    return torch.where((u & _SIGN) != 0, _FULL - u, u | _SIGN)


def _from_key(k: torch.Tensor) -> torch.Tensor:
    u = torch.where((k & _SIGN) != 0, k ^ _SIGN, _FULL - k)
    u = torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)
    return u.view(torch.float32)


def _kth_key(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Exact rank-k (1-indexed) smallest key along the last axis."""
    prefix = torch.zeros(keys.shape[:-1], dtype=torch.int64, device=keys.device)
    for bit in range(31, -1, -1):
        cand = prefix | (1 << bit)
        cnt = (keys < cand[..., None]).sum(-1)
        prefix = torch.where(cnt >= k, prefix, cand)
    return prefix


def _next_distinct_or_same(keys, kth_key, rank: int):
    kk = kth_key[..., None]
    le = (keys <= kk).sum(-1)
    bigger = torch.where(keys > kk, keys, torch.full_like(keys, _FULL)).amin(-1)
    return torch.where(le >= rank + 1, kth_key, bigger)


def _median_from_keys(keys, m: int):
    mid = m // 2
    if m % 2 == 1:
        return _from_key(_kth_key(keys, mid + 1))
    lo_key = _kth_key(keys, mid)
    hi_key = _next_distinct_or_same(keys, lo_key, mid)
    return 0.5 * (_from_key(lo_key) + _from_key(hi_key))


def row_features_stats_plain(C: torch.Tensor, colmin: torch.Tensor) -> torch.Tensor:
    """(…, n, m) f32 and its (…, m) column minima -> (…, n, 13)."""
    m = C.shape[-1]
    k = min(10, m)
    inv_m = 1.0 / m

    r_min = C.amin(-1)
    r_max = C.amax(-1)
    mean = C.sum(-1) * inv_m
    dm = C - mean[..., None]
    std = torch.sqrt(torch.clamp_min((dm * dm).sum(-1) * inv_m, 0.0))

    e = torch.exp(-(C - r_min[..., None]))
    p = e / (e.sum(-1, keepdim=True) + EPS)
    entropy = -(p * torch.log(p + EPS)).sum(-1)

    near = (C <= r_min[..., None] * 1.1).to(C.dtype).sum(-1) * inv_m

    min_cnt = (C == r_min[..., None]).sum(-1)
    above = torch.where(C > r_min[..., None], C, torch.inf).amin(-1)
    second = torch.where(min_cnt > 1, r_min, above)
    gap = second - r_min
    span = r_max - r_min
    competition = gap / (span + EPS)

    if m >= 2:
        difficulty = 1.0 / (span / (m - 1) + EPS)
    else:
        difficulty = torch.zeros_like(r_min)

    keys = _to_key(C)
    med = _median_from_keys(keys, m)
    dkeys = _to_key(torch.abs(C - med[..., None]))
    mad = torch.clamp_min(_median_from_keys(dkeys, m), EPS)

    t_key = _kth_key(keys, k)
    T = _from_key(t_key)
    below = keys < t_key[..., None]
    c_lt = below.sum(-1)
    take = (k - c_lt).to(C.dtype)
    ks1 = torch.where(below, C, 0.0).sum(-1) + take * T
    k_mean = ks1 / k
    d = C - k_mean[..., None]
    ksd = torch.where(below, d * d, 0.0).sum(-1)
    dT = T - k_mean
    k_std = torch.sqrt(torch.clamp_min((ksd + take * dT * dT) / k, 0.0))

    is_col_best = (C == colmin[..., None, :]).to(C.dtype).sum(-1) * inv_m

    if m < 2:
        gap = torch.zeros_like(r_min)
        competition = torch.zeros_like(r_min)

    return torch.stack(
        [r_min, r_max, mean, std, mad, entropy, gap, competition,
         k_mean, k_std, difficulty, near, is_col_best],
        dim=-1,
    )


def row_features_stats(C: torch.Tensor) -> torch.Tensor:
    """K3: (n, m) -> (n, 13) or (B, n, m) -> (B, n, 13) statistics block.

    is-col-best needs the column minima: they come from K1 (``col_min``)
    inside this wrapper, as ``pallas_col_min`` does inside the TPU wrapper,
    so K1 runs once per call.  CPU tensors take the plain versions."""
    if C.device.type == "cpu":
        return row_features_stats_plain(C, col_min(C))
    if C.device.type != "cuda":
        raise ValueError(f"row_features_stats: unsupported device {C.device}")
    if C.dtype != torch.float32:
        raise TypeError(f"row_features_stats: C must be float32, got {C.dtype}")
    if C.ndim not in (2, 3):
        raise ValueError(
            f"row_features_stats: C must be (n, m) or (B, n, m), got {tuple(C.shape)}"
        )
    if not C.is_contiguous():
        raise ValueError("row_features_stats: C must be contiguous")
    Cb = C if C.ndim == 3 else C[None]
    B, n, m = Cb.shape
    if n < 1 or m < 1:
        raise ValueError(f"row_features_stats: empty matrix {tuple(C.shape)}")
    from ._lib import KERNEL_LIBS, check, ptr, stream_ptr

    lib = KERNEL_LIBS["features"].load()
    with torch.cuda.device(Cb.device):
        max_m = lib.lapgnn_row_features_max_m(Cb.device.index or 0)
        if max_m < 0:
            check(-max_m, "row_features_stats shared-memory query")
        if m > max_m:
            raise ValueError(
                f"row_features_stats: a row of m={m} floats exceeds the "
                f"{max_m}-float shared-memory limit of this card"
            )
        if B * n >= 2**31:
            raise ValueError("row_features_stats: B*n exceeds the grid limit")
        colmin = col_min(Cb)
        out = torch.empty((B, n, len(STAT_CHANNELS)), dtype=torch.float32, device=Cb.device)
        rc = lib.lapgnn_row_features_stats(
            ptr(Cb), ptr(colmin), ptr(out), B, n, m, min(10, m),
            stream_ptr(Cb.device),
        )
    check(rc, "row_features_stats kernel")
    row_features_stats.launches += 1
    return out if C.ndim == 3 else out[0]


row_features_stats.launches = 0
