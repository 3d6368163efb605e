"""Seeded (warm-started) Jonker–Volgenant solver on torch tensors.

Port of ``lapgnn_tpu/solver/seeded.py``: feasibility projection of the seed,
row tightening, a parallel greedy matching on the tight edges, the seed
gates with the cold fallback, Jacobi ARR, min-plus sweep augmentation and the
exactness polish.  Exactly optimal whatever the seed; a bad seed only costs
time.

The bid of every Jacobi-ARR round is kernel K4 (``ops.cuda.two_min``): the
per-row min1, argmin and min2 of C - v in one read of C, bit-identical to the
three-pass form of the JAX version (seeded.py:199-202).  The rest of each
round (the column-side scatters) and every other O(n^2) pass are plain
PyTorch, as they are plain XLA in the JAX version.

``lapjv_seeded_single`` computes ``column_reduction`` only when the gate
chooses the cold fallback, where the JAX version computes it always and
selects (seeded.py:335-340); the result is identical.  The batch solves
instance by instance, as the JAX serving program does (pipeline.py:473).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.cuda.twomin import two_min
from .jv import (
    INT,
    Matching,
    SolveStats,
    augment_all_sweep,
    column_reduction,
    matching_cost,
    polish_matching,
)

__all__ = [
    "FALLBACK_DENSITY",
    "SeededResult",
    "default_tight_eps",
    "greedy_tight_matching",
    "jacobi_arr",
    "lapjv_seeded_batch",
    "lapjv_seeded_single",
]

# Tight-edge density below which the seed is deemed useless (the reference's
# 1.2 n rule, lapjv_seeded.cpp:116).
FALLBACK_DENSITY = 1.2

_U32 = 0xFFFFFFFF
_INT32_MAX = 2**31 - 1


def default_tight_eps(dtype: torch.dtype) -> float:
    """Tightness tolerance matched to precision: 1e-9 in float64, 1e-5
    otherwise (below float32's epsilon for O(1) costs 1e-9 would be void)."""
    return 1e-9 if dtype == torch.float64 else 1e-5


def _as_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float (exact in it)."""
    return torch.tensor(value, dtype=dtype).item()


def _hash_scores(n: int, rnd: int, device=None) -> torch.Tensor:
    """Deterministic per-(row, col, round) int32 scores in [0, 2^31 - 2]
    (seeded.py:71): the JAX version's wrapping uint32 arithmetic, emulated in
    int64 with a 32-bit mask after every multiply and add.  Each product
    stays below 2^63: a 32-bit value times a constant below 2^30, or
    i * 0x9E3779B1 for i < 2^31."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    hi = (i * 0x9E3779B1) & _U32
    hj = (i * 0x85EBCA77) & _U32
    hr = (rnd * 0xC2B2AE3D) & _U32
    h = (hi[:, None] + hj[None, :] + hr) & _U32
    h = h ^ (h >> 15)
    h = (h * 0x27D4EB2F) & _U32
    h = h ^ (h >> 13)
    # strictly below the 'unavailable' sentinel 0x7FFFFFFF of the greedy
    return torch.clamp_max(h & 0x7FFFFFFF, 0x7FFFFFFE).to(torch.int32)


def greedy_tight_matching(
    tight: torch.Tensor, stats: Optional[SolveStats] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximal matching on the tight-edge graph by parallel proposal rounds
    (seeded.py:99): every free row proposes its lowest available column in
    round 0 and its lowest-hash one later; each column accepts the lowest
    proposing row; until a round matches nothing."""
    stats = SolveStats() if stats is None else stats
    n = tight.shape[-1]
    dev = tight.device
    iota = torch.arange(n, dtype=INT, device=dev)
    col_ids = iota.to(torch.int32)[None, :].expand(n, n)
    x = torch.full((n,), -1, dtype=INT, device=dev)
    y = torch.full((n,), -1, dtype=INT, device=dev)
    rnd, progressed = 0, True
    while progressed:
        avail = tight & (y < 0)[None, :] & (x < 0)[:, None]
        has_any = avail.any(1)
        score = col_ids if rnd == 0 else _hash_scores(n, rnd, dev)
        score = torch.where(avail, score, _INT32_MAX)
        prop_j = score.argmin(1)
        prop_j_safe = torch.where(has_any, prop_j, n)
        winner = torch.full((n + 1,), n, dtype=INT, device=dev).scatter_reduce_(
            0, prop_j_safe, torch.where(has_any, iota, n), "amin"
        )
        won = has_any & (winner[prop_j_safe] == iota)
        x = torch.where(won, prop_j, x)
        y_scatter = torch.full((n + 1,), -1, dtype=INT, device=dev).scatter_reduce_(
            0, torch.where(won, prop_j, n), torch.where(won, iota, -1), "amax"
        )[:n]
        y = torch.where(y_scatter >= 0, y_scatter, y)
        rnd += 1
        progressed = stats.item(won.any())
    stats.greedy_rounds += rnd
    return x, y


def jacobi_arr(
    C: torch.Tensor,
    m: Matching,
    max_rounds: int = 64,
    min_delta: float = 0.0,
    stats: Optional[SolveStats] = None,
) -> Matching:
    """Parallel (Jacobi) augmenting row reduction, an epsilon = 0 auction
    (seeded.py:163).  Each round every free row bids for its cheapest column
    with the gap to its second cheapest (K4); each column takes the largest
    gap (ties to the lowest row), lowers its potential by it and kicks its
    previous owner.  Until a round wins nothing or ``max_rounds``."""
    stats = SolveStats() if stats is None else stats
    n = C.shape[-1]
    dev = C.device
    iota = torch.arange(n, dtype=INT, device=dev)
    neg_inf = float("-inf")
    x, y, v = m
    rnd, progressed = 0, True
    while rnd < max_rounds and progressed:
        min1, min2, j1 = two_min(C, v)
        j1 = j1.to(INT)
        delta = min2 - min1
        bid = (x < 0) & (delta > min_delta) & torch.isfinite(min2)
        j1_safe = torch.where(bid, j1, n)
        col_best = torch.full((n + 1,), neg_inf, dtype=C.dtype, device=dev).scatter_reduce_(
            0, j1_safe, torch.where(bid, delta, neg_inf), "amax"
        )
        cand = bid & (delta >= col_best[j1_safe])
        win_row = torch.full((n + 1,), n, dtype=INT, device=dev).scatter_reduce_(
            0, torch.where(cand, j1, n), torch.where(cand, iota, n), "amin"
        )
        won = cand & (win_row[j1_safe] == iota)
        j1_won = torch.where(won, j1, n)
        dv = torch.zeros((n + 1,), dtype=C.dtype, device=dev).scatter_reduce_(
            0, j1_won, torch.where(won, delta, 0.0), "amax"
        )
        v = v - dv[:n]
        new_owner = torch.full((n + 1,), -1, dtype=INT, device=dev).scatter_reduce_(
            0, j1_won, torch.where(won, iota, -1), "amax"
        )[:n]
        kicked = torch.where(new_owner >= 0, y, -1)
        x = torch.cat([x, x.new_full((1,), -1)]).index_fill_(
            0, torch.where(kicked >= 0, kicked, n), -1
        )[:n]
        x = torch.where(won, j1, x)
        y = torch.where(new_owner >= 0, new_owner, y)
        rnd += 1
        progressed = stats.item(won.any())
    stats.arr_rounds += rnd
    return Matching(x, y, v)


class SeededResult(NamedTuple):
    col_of_row: torch.Tensor
    row_of_col: torch.Tensor
    cost: torch.Tensor
    used_fallback: torch.Tensor
    # Final column duals: with u_i = C[i, x_i] - v[x_i] they certify the
    # assignment (the f64 certificate of the pipeline's device mode).
    v: torch.Tensor


def lapjv_seeded_single(
    C: torch.Tensor,
    u_seed: torch.Tensor,
    v_seed: torch.Tensor,
    eps: float = 1e-12,
    project_rounds: int = 2,
    gate: str = "density",
    free_rows_frac: float = 0.5,
    arr_rounds: Optional[int] = None,
    stats: Optional[SolveStats] = None,
) -> SeededResult:
    """Warm-started dense JV solve of one square instance (seeded.py:260).

    ``gate`` selects the cold-fallback criterion: "density" (fewer than
    1.2 n tight edges), "free_rows" (greedy leaves more than
    ``free_rows_frac`` of the rows free), "both" (both say so) or "never".
    ``arr_rounds`` overrides the ARR round cap max(64, n // 32).  With
    ``stats.timed`` the stages are timed as ``project_tighten``, ``greedy``,
    ``arr``, ``augment`` and ``polish``."""
    if gate not in ("density", "free_rows", "both", "never"):
        raise ValueError(f"unknown gate '{gate}'")
    stats = SolveStats() if stats is None else stats
    n = C.shape[-1]
    dev = C.device
    tight_eps = _as_dtype(max(eps, default_tight_eps(C.dtype)), C.dtype)

    with stats.stage("project_tighten", dev):
        u = u_seed.to(C.dtype)
        v = v_seed.to(C.dtype)
        for _ in range(project_rounds):
            u = torch.minimum(u, (C - v[None, :]).amin(1))
            v = torch.minimum(v, (C - u[:, None]).amin(0))
        u = (C - v[None, :]).amin(1)
        tight = (C - u[:, None] - v[None, :]).abs() <= tight_eps

    with stats.stage("greedy", dev):
        x, y = greedy_tight_matching(tight, stats)
        # the JAX version counts in float32, exact below 2^24 and far above
        # both thresholds there
        n_tight, n_free = stats.to_host(torch.stack([tight.sum(), (x < 0).sum()]))
    density_bad = n_tight < _as_dtype(FALLBACK_DENSITY * n, torch.float32)
    free_bad = n_free > _as_dtype(free_rows_frac * n, torch.float32)
    use_fallback = {
        "density": density_bad,
        "free_rows": free_bad,
        "both": density_bad and free_bad,
        "never": False,
    }[gate]
    m = column_reduction(C) if use_fallback else Matching(x, y, v)

    rounds = arr_rounds if arr_rounds is not None else max(64, n // 32)
    with stats.stage("arr", dev):
        m = jacobi_arr(C, m, max_rounds=rounds, stats=stats)
    with stats.stage("augment", dev):
        m = augment_all_sweep(C, m, stats)
    with stats.stage("polish", dev):
        m = polish_matching(C, m, stats=stats)
    return SeededResult(
        col_of_row=m.col_of_row,
        row_of_col=m.row_of_col,
        cost=matching_cost(C, m.col_of_row),
        used_fallback=torch.full((), use_fallback, dtype=torch.bool, device=dev),
        v=m.v,
    )


def lapjv_seeded_batch(
    C: torch.Tensor,
    u_seed: torch.Tensor,
    v_seed: torch.Tensor,
    eps: float = 1e-12,
    project_rounds: int = 2,
    gate: str = "density",
    free_rows_frac: float = 0.5,
    arr_rounds: Optional[int] = None,
) -> SeededResult:
    """(B, n, n) with (B, n) seeds: ``lapjv_seeded_single`` instance by
    instance, fields stacked."""
    outs = [
        lapjv_seeded_single(
            C[b], u_seed[b], v_seed[b], eps=eps, project_rounds=project_rounds,
            gate=gate, free_rows_frac=free_rows_frac, arr_rounds=arr_rounds,
        )
        for b in range(C.shape[0])
    ]
    return SeededResult(*(torch.stack(parts) for parts in zip(*outs)))
