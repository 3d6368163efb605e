"""Seeded (warm-started) Jonker–Volgenant solver on torch tensors.

Port of ``lapgnn_tpu/solver/seeded.py``: feasibility projection of the seed,
row tightening, a parallel greedy matching on the tight edges, the seed
gates with the cold fallback, Jacobi ARR, min-plus sweep augmentation and the
exactness polish.  Exactly optimal whatever the seed; a bad seed only costs
time.

On the card, for a partition that holds every row, each loop is one
cooperative launch of a hand-written kernel: the greedy rounds S3
(``ops.cuda.greedy_match``), the Jacobi-ARR rounds S2 (``ops.cuda.arr_auction``,
whose bid is K4's own device code) and the sweep augmentation S1
(``solver.jv.augment_all_sweep``); the cold-fallback gate is a select on the
device, as in the JAX version (seeded.py:305-340): ``column_reduction`` is
computed always and each field of the start state picked by
``torch.where``, so ``used_fallback`` is a device bool.  From the seed to
the result the solve reads nothing back on the host.  On the CPU, and on a
row block of a ``ShardedRows`` of more than one rank (whose every round
needs a collective, which a kernel cannot make: the sharded path's own
code, not a fallback), the loops are the eager ones, each condition read
back on the host (``_greedy_tight_matching_eager``, ``_jacobi_arr_eager``
with K4 as the bid); they are also S3's and S2's plain versions.  The
batch solves instance by instance, as the JAX serving program does
(pipeline.py:473); with nothing read between instances the launches queue
back to back.

Each phase takes the row partition ``part`` of ``solver.jv``: C may be one
rank's block of rows (``parallel.sharded.ShardedRows``), while the matching
(x, y) and the duals v are held whole on every rank.  The greedy and ARR
rounds therefore update x from the column-side winners (each won column's
new row), which every rank holds, instead of from the row-side flags.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import tracing
from ..ops.cuda.arr import arr_auction
from ..ops.cuda.greedy_match import greedy_match
from ..ops.cuda.twomin import two_min
from ..ops.partition import WHOLE, RowPartition
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


def _hash_scores(
    n: int, rnd: int, device=None, row0: int = 0, rows: Optional[int] = None
) -> torch.Tensor:
    """Deterministic per-(row, col, round) int32 scores in [0, 2^31 - 2]
    (seeded.py:71): the JAX version's wrapping uint32 arithmetic, emulated in
    int64 with a 32-bit mask after every multiply and add.  Each product
    stays below 2^63: a 32-bit value times a constant below 2^30, or
    i * 0x9E3779B1 for i < 2^31.  ``row0`` and ``rows`` select the rows
    [row0, row0 + rows) of the (n, n) scores (default: all)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    rows_i = i if rows is None else torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)
    hi = (rows_i * 0x9E3779B1) & _U32
    hj = (i * 0x85EBCA77) & _U32
    hr = (rnd * 0xC2B2AE3D) & _U32
    h = (hi[:, None] + hj[None, :] + hr) & _U32
    h = h ^ (h >> 15)
    h = (h * 0x27D4EB2F) & _U32
    h = h ^ (h >> 13)
    # strictly below the 'unavailable' sentinel 0x7FFFFFFF of the greedy
    return torch.clamp_max(h & 0x7FFFFFFF, 0x7FFFFFFE).to(torch.int32)


def _assign_cols(x: torch.Tensor, new_row: torch.Tensor) -> torch.Tensor:
    """x with x[new_row[j]] = j for every column j with new_row[j] >= 0."""
    n = x.shape[0]
    got = new_row >= 0
    cols = torch.arange(n, dtype=INT, device=x.device)
    return torch.cat([x, x.new_full((1,), -1)]).scatter_(
        0, torch.where(got, new_row, n), torch.where(got, cols, -1)
    )[:n]


def greedy_tight_matching(
    tight: torch.Tensor, stats: Optional[SolveStats] = None, part: RowPartition = WHOLE
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximal matching on the tight-edge graph by parallel proposal rounds
    (seeded.py:99): every free row proposes its lowest available column in
    round 0 and its lowest-hash one later; each column accepts the lowest
    proposing row; until a round matches nothing.  ``tight`` holds
    ``part``'s rows; x and y come back for every row.  A CUDA matrix whose
    partition holds every row launches kernel S3 (or raises)."""
    stats = SolveStats() if stats is None else stats
    if tight.device.type == "cpu" or part.size > 1:
        return _greedy_tight_matching_eager(tight, stats, part)
    return greedy_match(tight.contiguous(), stats.device_counts(tight.device)[0:1])


def _greedy_tight_matching_eager(
    tight: torch.Tensor, stats: SolveStats, part: RowPartition = WHOLE
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``greedy_tight_matching`` as eager PyTorch, each round's progress
    read on the host: the CPU path, the sharded path and S3's plain
    version."""
    n_loc, n = tight.shape
    dev = tight.device
    rows = torch.arange(part.offset, part.offset + n_loc, dtype=INT, device=dev)
    col_ids = torch.arange(n, dtype=torch.int32, device=dev)[None, :].expand(n_loc, n)
    x = torch.full((n,), -1, dtype=INT, device=dev)
    y = torch.full((n,), -1, dtype=INT, device=dev)
    rnd, progressed = 0, True
    while progressed:
        avail = tight & (y < 0)[None, :] & (part.local(x) < 0)[:, None]
        has_any = avail.any(1)
        score = col_ids if rnd == 0 else _hash_scores(n, rnd, dev, part.offset, n_loc)
        score = torch.where(avail, score, _INT32_MAX)
        prop_j = score.argmin(1)
        prop_j_safe = torch.where(has_any, prop_j, n)
        winner = part.min(torch.full((n + 1,), n, dtype=INT, device=dev).scatter_reduce_(
            0, prop_j_safe, torch.where(has_any, rows, n), "amin"
        ))
        # each proposed-to column takes its lowest proposing row
        y_scatter = torch.where(winner < n, winner, -1)[:n]
        x = _assign_cols(x, y_scatter)
        y = torch.where(y_scatter >= 0, y_scatter, y)
        rnd += 1
        progressed = stats.item((y_scatter >= 0).any())
    stats.greedy_rounds += rnd
    return x, y


def jacobi_arr(
    C: torch.Tensor,
    m: Matching,
    max_rounds: int = 64,
    min_delta: float = 0.0,
    stats: Optional[SolveStats] = None,
    part: RowPartition = WHOLE,
) -> Matching:
    """Parallel (Jacobi) augmenting row reduction, an epsilon = 0 auction
    (seeded.py:163).  Each round every free row bids for its cheapest column
    with the gap to its second cheapest; each column takes the largest gap
    (ties to the lowest row), lowers its potential by it and kicks its
    previous owner.  Until a round wins nothing or ``max_rounds``.  A CUDA
    matrix whose partition holds every row launches kernel S2 (or raises)."""
    stats = SolveStats() if stats is None else stats
    if C.device.type == "cpu" or part.size > 1:
        return _jacobi_arr_eager(C, m, max_rounds, min_delta, stats, part)
    counts = stats.device_counts(C.device)[1:2]
    return Matching(*arr_auction(C, m.col_of_row, m.row_of_col, m.v, max_rounds, min_delta,
                                 counts))


def _jacobi_arr_eager(
    C: torch.Tensor,
    m: Matching,
    max_rounds: int,
    min_delta: float,
    stats: SolveStats,
    part: RowPartition = WHOLE,
    bid=None,
) -> Matching:
    """``jacobi_arr`` as eager PyTorch, each round's progress read on the
    host, the bid by ``bid`` (default K4, ``two_min``): the CPU path, the
    sharded path and, with ``two_min_plain``, S2's plain version."""
    bid_fn = two_min if bid is None else bid
    n_loc, n = C.shape
    dev = C.device
    rows = torch.arange(part.offset, part.offset + n_loc, dtype=INT, device=dev)
    x, y, v = m
    rnd, progressed = 0, True
    while rnd < max_rounds and progressed:
        min1, min2, j1 = bid_fn(C, v)
        j1 = j1.to(INT)
        delta = min2 - min1
        bid = (part.local(x) < 0) & (delta > min_delta) & torch.isfinite(min2)
        col_best, win_row = part.best_bid(torch.where(bid, j1, n), delta, rows, n)
        win_row = win_row[:n]
        # a column bid for goes to its largest gap, the lowest row on a tie,
        # and drops its potential by that gap where it is positive
        got = win_row < n
        v = v - torch.where(got & (col_best[:n] > 0), col_best[:n], 0.0)
        new_owner = torch.where(got, win_row, -1)
        kicked = torch.where(new_owner >= 0, y, -1)
        x = torch.cat([x, x.new_full((1,), -1)]).index_fill_(
            0, torch.where(kicked >= 0, kicked, n), -1
        )[:n]
        # each winner was free, so it is no kicked row
        x = _assign_cols(x, new_owner)
        y = torch.where(new_owner >= 0, new_owner, y)
        rnd += 1
        progressed = stats.item((new_owner >= 0).any())
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


@tracing.spanned("seeded", lambda C, *args, **kwargs: C.device)
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
    part: RowPartition = WHOLE,
) -> SeededResult:
    """Warm-started dense JV solve of one square instance (seeded.py:260).

    ``gate`` selects the cold-fallback criterion: "density" (fewer than
    1.2 n tight edges), "free_rows" (greedy leaves more than
    ``free_rows_frac`` of the rows free), "both" (both say so) or "never".
    ``arr_rounds`` overrides the ARR round cap max(64, n // 32).  With
    ``stats.timed`` the stages are timed as ``project_tighten``, ``greedy``,
    ``arr``, ``augment`` and ``polish``.  The solve is the tracer's span
    ``lapgnn.seeded``, the stages' spans inside it.  With a row-sharded
    ``part``, C and ``u_seed`` hold the rank's rows and ``v_seed`` every
    column; the result is the whole matching on every rank."""
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
            v = torch.minimum(v, part.min_trick(C, u))
        u = (C - v[None, :]).amin(1)
        tight = (C - u[:, None] - v[None, :]).abs() <= tight_eps

    with stats.stage("greedy", dev):
        x, y = greedy_tight_matching(tight, stats, part)

    # The gates as a select (seeded.py:305-340): the JAX version counts in
    # float32, exact below 2^24 and far above both thresholds there.
    n_tight = part.sum(tight.sum()).to(torch.float32)
    n_free = (x < 0).sum().to(torch.float32)
    density_bad = n_tight < _as_dtype(FALLBACK_DENSITY * n, torch.float32)
    free_bad = n_free > _as_dtype(free_rows_frac * n, torch.float32)
    use_fallback = {
        "density": density_bad,
        "free_rows": free_bad,
        "both": density_bad & free_bad,
        "never": torch.zeros((), dtype=torch.bool, device=dev),
    }[gate]
    cold = column_reduction(C, part)
    m = Matching(*(torch.where(use_fallback, c, w) for c, w in zip(cold, (x, y, v))))

    rounds = arr_rounds if arr_rounds is not None else max(64, n // 32)
    with stats.stage("arr", dev):
        m = jacobi_arr(C, m, max_rounds=rounds, stats=stats, part=part)
    with stats.stage("augment", dev):
        m = augment_all_sweep(C, m, stats, part)
    with stats.stage("polish", dev):
        m = polish_matching(C, m, stats=stats, part=part)
    return SeededResult(
        col_of_row=m.col_of_row,
        row_of_col=m.row_of_col,
        cost=matching_cost(C, m.col_of_row, part),
        used_fallback=use_fallback,
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
