"""Jonker–Volgenant building blocks of the device solver, on torch tensors.

Port of ``lapgnn_tpu/solver/jv.py``: the column reduction, the min-plus
sweep augmentation that flips a tie group of augmenting paths per round, the
exactness polish, and the cold solve built from them.  Names and signatures
follow the JAX module; each function also takes an optional ``stats``
(:class:`SolveStats`) that counts its loop iterations and host syncs.

Each ``lax.while_loop`` of the JAX version is a Python ``while`` here, whose
condition is read back with one host sync per iteration; every bound of the
JAX loop is kept (``_bounded_augment_loop`` stops after n + 1 rounds, a sweep
after n + 1 sweeps), so a poisoned input returns instead of hanging.  The
pointer-chasing flip of the augmenting paths runs on the host over Python
lists, with one device-to-host copy of ``(x, y, pred_row, cand)`` and one
copy of ``(x, y)`` back per augmentation round.

Indices are int64 (torch's index type; the JAX module uses int32).  Every
float operation is the JAX one in the same order, so on the same float32
input the assignments and duals equal the JAX solver's bit for bit; the
argmins take the first index on ties, as ``jnp.argmin`` does.

Not ported: the pop-at-a-time Dijkstra family (``augment_all``,
``augment_all_multisource`` and their helpers), which no serving path runs.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

__all__ = [
    "Matching",
    "SolveStats",
    "column_reduction",
    "augment_all_sweep",
    "polish_matching",
    "lapjv_single",
    "lapjv_batch",
    "matching_cost",
]

INT = torch.int64

# Fixed path-length cap of the multi-augmentation flip (jv.py:407): a sink
# whose path is longer is deferred to the next round.
_PATH_CAP = 64


class Matching(NamedTuple):
    """col_of_row: (n,) int64, -1 if free; row_of_col: (n,) int64, -1 if
    free; v: (n,) column dual potentials."""

    col_of_row: torch.Tensor
    row_of_col: torch.Tensor
    v: torch.Tensor


@dataclass
class SolveStats:
    """Loop counts of one solve, and its host syncs: each read of a device
    value by the host (a loop condition, the flip's copies).  With ``timed``
    each stage synchronises the device before and after itself and adds its
    host-clock time to ``stage_ms``; ``flip_ms`` is the host time of the
    path flips, copies included, and is always kept."""

    greedy_rounds: int = 0
    arr_rounds: int = 0
    aug_rounds: int = 0
    sweeps: int = 0
    flip_steps: int = 0
    host_syncs: int = 0
    flip_ms: float = 0.0
    timed: bool = False
    stage_ms: Dict[str, float] = field(default_factory=dict)

    def item(self, t: torch.Tensor):
        self.host_syncs += 1
        return t.item()

    def to_host(self, t: torch.Tensor) -> List:
        self.host_syncs += 1
        return t.cpu().tolist()

    def to_device(self, data: List, like: torch.Tensor) -> torch.Tensor:
        # a blocking host-to-device copy synchronises the stream as well
        self.host_syncs += 1
        return torch.tensor(data, dtype=like.dtype).to(like.device)

    @contextmanager
    def stage(self, name: str, device: torch.device):
        if not self.timed:
            yield
            return
        _synchronize(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _synchronize(device)
            ms = (time.perf_counter() - t0) * 1e3
            self.stage_ms[name] = self.stage_ms.get(name, 0.0) + ms


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def matching_cost(C: torch.Tensor, col_of_row: torch.Tensor) -> torch.Tensor:
    """Total assignment cost sum_i C[i, x_i] (batched over leading dims).
    A free row (-1) reads the last column, as ``jnp.take_along_axis``
    normalises a negative index."""
    x = col_of_row.to(INT)
    x = torch.where(x < 0, x + C.shape[-1], x)
    return C.gather(-1, x[..., None])[..., 0].sum(-1)


def column_reduction(C: torch.Tensor) -> Matching:
    """Column reduction + reduction transfer (jv.py:71).

    v_j = min_i C_ij with y_j its first argmin row; a row claimed by several
    columns keeps the largest (scatter-max); a uniquely claimed row gives
    v[x_i] -= min_{j != x_i} (C_ij - v_j), unless that minimum is not finite.
    """
    n = C.shape[-1]
    iota = torch.arange(n, dtype=INT, device=C.device)
    v, y0 = torch.min(C, dim=0)
    x = torch.full((n,), -1, dtype=INT, device=C.device).scatter_reduce_(
        0, y0, iota, "amax"
    )
    y = torch.where(x[y0] == iota, y0, -1)
    claims = torch.bincount(y0, minlength=n)
    unique_rows = (claims == 1) & (x >= 0)
    red = C - v[None, :]
    red_excl = torch.where(iota[None, :] == x[:, None], float("inf"), red)
    slack = red_excl.amin(1)
    safe_x = torch.where(x >= 0, x, 0)
    delta = torch.where(unique_rows & torch.isfinite(slack), slack, 0.0)
    # x is injective on assigned rows; the free rows add -0.0 at column 0.
    v = v.index_add(0, safe_x, -delta)
    return Matching(x, y, v)


def _bounded_augment_loop(
    m: Matching,
    n: int,
    round_fn: Callable[[Matching], Matching],
    stats: Optional[SolveStats] = None,
) -> Matching:
    """Run ``round_fn`` while a row is free, at most n + 1 rounds (jv.py:223):
    on a NaN or all-forbidden row no flip happens, and the bound returns a
    partial matching instead of spinning."""
    stats = SolveStats() if stats is None else stats
    it = 0
    while it <= n and stats.item((m.col_of_row < 0).any()):
        m = round_fn(m)
        it += 1
    stats.aug_rounds += it
    return m


def _sweep_shortest_paths(
    red: torch.Tensor,
    free_row: torch.Tensor,
    x_safe: torch.Tensor,
    d0: torch.Tensor,
    pred0: torch.Tensor,
    max_sweeps: int,
    free_col: Optional[torch.Tensor] = None,
    stats: Optional[SolveStats] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min-plus Bellman–Ford over columns relaxed through rows (jv.py:346):
    d_k = min(d_k, min_{matched i} (d[x_i] + red[i, k])), first-index argmin
    for the predecessor row.  With ``free_col`` it stops once nothing at or
    below the best free-column distance changes."""
    stats = SolveStats() if stats is None else stats
    inf = float("inf")
    tol = 8.0 * torch.finfo(red.dtype).eps
    d, pred_row = d0, pred0
    changed, sweeps = True, 0
    while changed and sweeps <= max_sweeps:
        e = torch.where(free_row, inf, d[x_safe])
        best, best_i = torch.min(e[:, None] + red, dim=0)
        improve = best < d
        d = torch.where(improve, best, d)
        pred_row = torch.where(improve, best_i, pred_row)
        if free_col is None:
            flag = improve.any()
        else:
            dmin_free = torch.where(free_col, d, inf).amin()
            thresh = dmin_free + tol * (1.0 + dmin_free.abs())
            flag = (improve & (d <= thresh)).any()
        sweeps += 1
        changed = stats.item(flag)
    stats.sweeps += sweeps
    return d, pred_row


def _flip_single_path_host(x: List[int], y: List[int], pred_row: List[int], j: int) -> int:
    """Flip one augmenting path in place with an n-bounded walk (jv.py:410).
    Returns the steps walked."""
    n = len(pred_row)
    k, done = 0, False
    while not done and k <= n:
        i = pred_row[j]
        next_j = x[i]
        y[j] = i
        x[i] = j
        done = next_j < 0
        k += 1
        j = next_j
    return k


def _flip_disjoint_paths_host(
    x: List[int], y: List[int], pred_row: List[int], cand: List[bool]
) -> int:
    """``_flip_disjoint_paths`` (jv.py:437) over Python lists, in place:
    candidates lowest first, a path that touches a row used this round or
    runs past ``_PATH_CAP`` hops is skipped, and when nothing flipped the
    first sink's path is flipped uncapped.  Returns the steps walked."""
    n = len(pred_row)
    sinks = [j for j, c in enumerate(cand) if c]
    used_row = [False] * n
    flipped_any = False
    steps = 0
    for j0 in sinks[:n]:
        rows: List[int] = []
        cols: List[int] = []
        j, ok, done = j0, True, False
        while not done and ok and len(rows) < _PATH_CAP:
            i = pred_row[j]
            ok = not used_row[i]
            rows.append(i)
            cols.append(j)
            j = x[i]
            done = j < 0
        steps += len(rows)
        if ok and done:
            for i, jj in zip(rows, cols):
                x[i] = jj
                y[jj] = i
                used_row[i] = True
            flipped_any = True
    if sinks and not flipped_any:
        # nothing flipped, so x and y are still the round's originals
        steps += _flip_single_path_host(x, y, pred_row, sinks[0])
    return steps


def _flip_single_path(
    x: torch.Tensor,
    y: torch.Tensor,
    pred_row: torch.Tensor,
    final_j: int,
    stats: Optional[SolveStats] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flip the augmenting path ending at free column ``final_j`` with an
    n-bounded walk (jv.py:410), on the host as ``_flip_disjoint_paths``."""
    stats = SolveStats() if stats is None else stats
    xs, ys, pred = stats.to_host(torch.stack([x, y, pred_row.to(INT)]))
    stats.flip_steps += _flip_single_path_host(xs, ys, pred, int(final_j))
    xy = stats.to_device([xs, ys], x)
    return xy[0], xy[1]


def _flip_disjoint_paths(
    x: torch.Tensor,
    y: torch.Tensor,
    pred_row: torch.Tensor,
    cand: torch.Tensor,
    stats: Optional[SolveStats] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flip a maximal set of row-disjoint augmenting paths ending at the
    ``cand`` columns: one copy of (x, y, pred_row, cand) to the host, the
    walk in Python, one copy of (x, y) back."""
    stats = SolveStats() if stats is None else stats
    t0 = time.perf_counter()
    xs, ys, pred, cs = stats.to_host(torch.stack([x, y, pred_row.to(INT), cand.to(INT)]))
    stats.flip_steps += _flip_disjoint_paths_host(xs, ys, pred, cs)
    xy = stats.to_device([xs, ys], x)
    stats.flip_ms += (time.perf_counter() - t0) * 1e3
    return xy[0], xy[1]


def augment_all_sweep(
    C: torch.Tensor, m: Matching, stats: Optional[SolveStats] = None
) -> Matching:
    """Augment free rows by min-plus sweep shortest paths, a tie group of
    paths per round (jv.py:533): implicit row potentials, clamped reduced
    costs, sweeps from all free rows at once, the settled-set dual update
    v += min(d, delta) - delta, then the disjoint-path flip of every free
    column within a few ulps of delta."""
    stats = SolveStats() if stats is None else stats
    n = C.shape[-1]
    inf = float("inf")
    eps8 = 8.0 * torch.finfo(C.dtype).eps

    def body(m: Matching) -> Matching:
        x, y, v = m
        free_row = x < 0
        free_col = y < 0
        slack = C - v[None, :]
        x_safe = torch.where(x >= 0, x, 0)
        u_matched = slack.gather(1, x_safe[:, None])[:, 0]
        u_free = slack.amin(1)
        u = torch.where(free_row, u_free, u_matched)
        red = slack - u[:, None]
        # jnp.maximum(red, 0.0): +0.0 for either zero, NaN propagates
        red = torch.where(red <= 0, 0.0, red)
        src = torch.where(free_row[:, None], red, inf)
        d0, pred0 = torch.min(src, dim=0)
        d, pred_row = _sweep_shortest_paths(red, free_row, x_safe, d0, pred0, n, free_col, stats)
        d_free = torch.where(free_col, d, inf)
        delta = d_free.amin()
        v = v + torch.minimum(d, delta) - delta
        tie_tol = eps8 * (1.0 + delta.abs())
        cand = free_col & (d_free <= delta + tie_tol)
        x, y = _flip_disjoint_paths(x, y, pred_row, cand, stats)
        return Matching(x, y, v)

    return _bounded_augment_loop(m, n, body, stats)


def polish_matching(
    C: torch.Tensor,
    m: Matching,
    eps: Optional[float] = None,
    stats: Optional[SolveStats] = None,
) -> Matching:
    """Exactness polish (jv.py:602): unmatch every row whose matched slack
    exceeds its row minimum by more than the threshold, re-augment exactly."""
    n = C.shape[-1]
    iota = torch.arange(n, dtype=INT, device=C.device)
    x, y, v = m
    slack = C - v[None, :]
    x_safe = torch.where(x >= 0, x, 0)
    matched_slack = slack.gather(1, x_safe[:, None])[:, 0]
    viol = torch.where(x >= 0, matched_slack - slack.amin(1), 0.0)
    if eps is None:
        eps = 8.0 * torch.finfo(C.dtype).eps
        threshold = eps * (1.0 + C.abs().max())
    else:
        threshold = torch.tensor(eps, dtype=C.dtype, device=C.device)
    bad = viol > threshold
    x_new = torch.where(bad, -1, x)
    y_new = torch.full((n + 1,), -1, dtype=INT, device=C.device).scatter_reduce_(
        0, torch.where(x_new >= 0, x_new, n), torch.where(x_new >= 0, iota, -1), "amax"
    )[:n]
    return augment_all_sweep(C, Matching(x_new, y_new, v), stats)


def lapjv_single(
    C: torch.Tensor, stats: Optional[SolveStats] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve one dense square LAP cold.  Returns (col_of_row, row_of_col,
    cost).  On a GPU the matrix must be float32 (K4 runs the ARR bid)."""
    from .seeded import jacobi_arr  # local import: avoids a module cycle

    stats = SolveStats() if stats is None else stats
    n = C.shape[-1]
    m = column_reduction(C)
    m = jacobi_arr(C, m, max_rounds=max(64, n // 32), stats=stats)
    m = augment_all_sweep(C, m, stats)
    return m.col_of_row, m.row_of_col, matching_cost(C, m.col_of_row)


def lapjv_batch(C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, n, n): ``lapjv_single`` instance by instance, results stacked."""
    outs = [lapjv_single(c) for c in C]
    return tuple(torch.stack(parts) for parts in zip(*outs))
