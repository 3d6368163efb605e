"""Jonker–Volgenant building blocks of the device solver, on torch tensors.

Port of ``lapgnn_tpu/solver/jv.py``: the column reduction, the min-plus
sweep augmentation that flips a tie group of augmenting paths per round, the
exactness polish, and the cold solve built from them.  Names and signatures
follow the JAX module; each function also takes an optional ``stats``
(:class:`SolveStats`) that counts its loop iterations and host syncs.

On the card ``augment_all_sweep`` is one cooperative launch of kernel S1
(``ops.cuda.augment_sweep``, ``csrc/augment.cu``): every round, sweep and
flip on the device, as the JAX version's ``lax.while_loop``s run, with no
read by the host; its loop counts stay on the device in ``SolveStats``
until a caller reads them.  On the CPU, and on a row block of a
``ShardedRows`` of more than one rank (whose every sweep needs a collective,
which a kernel cannot make: the sharded path's own code, not a fallback),
each ``lax.while_loop`` is a Python ``while`` whose condition is read back
with one host sync per iteration (``_augment_all_sweep_eager``, also S1's
plain version); every bound of the JAX loop is kept
(``_bounded_augment_loop`` stops after n + 1 rounds, a sweep after n + 1
sweeps), so a poisoned input returns instead of hanging.  There the
pointer-chasing flip of the augmenting paths runs on the host over Python
lists, with one device-to-host copy of ``(x, y, pred_row, cand)`` and one
copy of ``(x, y)`` back per augmentation round.

Indices are int64 (torch's index type; the JAX module uses int32).  Every
float operation is the JAX one in the same order, so on the same float32
input the assignments and duals equal the JAX solver's bit for bit; the
argmins take the first index on ties, as ``jnp.argmin`` does.

The pop-at-a-time Dijkstra family (``augment_all``, ``augment_all_multisource``)
pops one column per iteration: the argmin over the open columns is read on the
host (one sync a pop), the relaxation through the popped column's row runs on
the device, and the flip walks the path on the host, as the sweep's flips do.
Its bounds are the JAX ones: at most n + 1 pops a search, n + 1 steps a flip,
n + 1 rounds.

The functions of the seeded solve's path also take a row partition
(``part``, ``ops.partition``).  The default, ``WHOLE``, holds every row and combines nothing;
``parallel.sharded.ShardedRows`` holds one contiguous block of rows per rank
and combines the O(n) partial results with collectives, so the same code is
the row-sharded solve.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from .. import tracing
from ..ops.cuda.augment import augment_sweep
from ..ops.partition import WHOLE, RowPartition

__all__ = [
    "Matching",
    "SolveStats",
    "column_reduction",
    "augment_all",
    "augment_all_multisource",
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


# The loop counts the solver kernels keep on the device, in this order.
DEVICE_COUNTS = ("greedy_rounds", "arr_rounds", "aug_rounds", "sweeps", "flip_steps")


class SolveStats:
    """Loop counts of one solve, and its host syncs: each read of a device
    value by the host during the solve (a loop condition, the flips' copies
    of the eager loops), each also one of the tracer's ``host_syncs``.  The
    kernels S1-S3 add their counts to ``device_counts`` on the device;
    reading a count after the solve copies them to the host once (not a sync
    of the solve).  Each stage is the tracer's span ``lapgnn.seeded.<stage>``
    (``tracing``), on the host clock.  With ``timed`` the stages are timed
    whether or not the tracer records: on the card by CUDA events recorded
    on the current stream, read when ``stage_ms`` is, on the CPU by the host
    clock."""

    def __init__(self, timed: bool = False):
        self.timed = timed
        self.pops = 0
        self.host_syncs = 0
        self._host = dict.fromkeys(DEVICE_COUNTS, 0)
        self._device: Optional[torch.Tensor] = None
        self._stage_ms: Dict[str, float] = {}
        self._stages: List[tracing.Span] = []

    def device_counts(self, device: torch.device) -> torch.Tensor:
        """The (5,) int64 slots of ``DEVICE_COUNTS`` the kernels add to."""
        if self._device is None:
            self._device = torch.zeros(len(DEVICE_COUNTS), dtype=torch.int64, device=device)
        return self._device

    def _fold(self) -> None:
        if self._device is not None:
            for name, count in zip(DEVICE_COUNTS, self._device.tolist()):
                self._host[name] += count
            self._device = None

    @property
    def stage_ms(self) -> Dict[str, float]:
        for span in self._stages:
            name = span.name.rsplit(".", 1)[1]
            self._stage_ms[name] = self._stage_ms.get(name, 0.0) + span.ms
        self._stages = []
        return self._stage_ms

    def item(self, t: torch.Tensor):
        self.host_syncs += 1
        return tracing.item(t)

    def to_host(self, t: torch.Tensor) -> List:
        self.host_syncs += 1
        return tracing.to_host(t).tolist()

    def to_device(self, data: List, like: torch.Tensor) -> torch.Tensor:
        # a blocking host-to-device copy synchronises the stream as well
        self.host_syncs += 1
        return tracing.to_device(torch.tensor(data, dtype=like.dtype), like.device)

    def stage(self, name: str, device: torch.device):
        """The span ``lapgnn.seeded.<name>`` around one stage of the solve."""
        if not self.timed:
            return tracing.span("seeded." + name)
        return tracing.span("seeded." + name, device, into=self._stages)


def _count_property(name: str) -> property:
    def get(self: SolveStats) -> int:
        self._fold()
        return self._host[name]

    def set_(self: SolveStats, value: int) -> None:
        self._fold()
        self._host[name] = value

    return property(get, set_, doc=f"The solve's {name.replace('_', ' ')}.")


for _name in DEVICE_COUNTS:
    setattr(SolveStats, _name, _count_property(_name))


def matching_cost(
    C: torch.Tensor, col_of_row: torch.Tensor, part: RowPartition = WHOLE
) -> torch.Tensor:
    """Total assignment cost sum_i C[i, x_i] (batched over leading dims).
    A free row (-1) reads the last column, as ``jnp.take_along_axis``
    normalises a negative index."""
    x = part.local(col_of_row.to(INT))
    x = torch.where(x < 0, x + C.shape[-1], x)
    return part.gather(C.gather(-1, x[..., None])[..., 0]).sum(-1)


def column_reduction(C: torch.Tensor, part: RowPartition = WHOLE) -> Matching:
    """Column reduction + reduction transfer (jv.py:71).

    v_j = min_i C_ij with y_j its first argmin row; a row claimed by several
    columns keeps the largest (scatter-max); a uniquely claimed row gives
    v[x_i] -= min_{j != x_i} (C_ij - v_j), unless that minimum is not finite.
    """
    n = C.shape[-1]
    iota = torch.arange(n, dtype=INT, device=C.device)
    v, y0 = part.argmin(C)
    x = torch.full((n,), -1, dtype=INT, device=C.device).scatter_reduce_(
        0, y0, iota, "amax"
    )
    y = torch.where(x[y0] == iota, y0, -1)
    # each row's claims, counted without bincount's read of the largest index
    claims = torch.zeros(n, dtype=INT, device=C.device).scatter_add_(0, y0, torch.ones_like(y0))
    unique_rows = (claims == 1) & (x >= 0)
    red = C - v[None, :]
    red_excl = torch.where(iota[None, :] == part.local(x)[:, None], float("inf"), red)
    slack = part.gather(red_excl.amin(1))
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


def _argmin_host(t: torch.Tensor, stats: SolveStats) -> int:
    """First index of the minimum of a vector, read on the host: the first
    NaN if there is one, as ``jnp.argmin``."""
    return int(stats.item(torch.argmin(t)))


def _dijkstra_to_free_col(
    C: torch.Tensor,
    row_of_col: List[int],
    v: torch.Tensor,
    d0: torch.Tensor,
    pred0: torch.Tensor,
    stats: SolveStats,
) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Pop the open column of least distance; stop at a free one, else relax
    every open column through the popped column's row (jv.py:120).  At most
    n + 1 pops: a NaN or all-inf search returns ``final_j = -1``.  Ends with
    the READY-set dual update v_j += d_j - mind on the popped columns.
    ``row_of_col`` is the host copy of y, fixed for the search."""
    n = C.shape[-1]
    inf = float("inf")
    d, pred = d0, pred0
    scanned = torch.zeros((n,), dtype=torch.bool, device=C.device)
    mind = torch.zeros((), dtype=C.dtype, device=C.device)
    final_j, steps = -1, 0
    while final_j < 0 and steps <= n:
        d_open = torch.where(scanned, inf, d)
        j = _argmin_host(d_open, stats)
        mind = d_open[j]
        i = row_of_col[j]
        steps += 1
        if i < 0:
            final_j = j
            break
        scanned[j] = True
        # the matched row's slack at its own column under the current d
        h = C[i, j] - v[j] - mind
        cand = C[i] - v - h
        improve = ~scanned & (cand < d)
        d = torch.where(improve, cand, d)
        pred = torch.where(improve, i, pred)
    stats.pops += steps
    return final_j, pred, torch.where(scanned, v + d - mind, v)


def _find_augmenting_path(
    C: torch.Tensor, free_row: int, row_of_col: List[int], v: torch.Tensor, stats: SolveStats
) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Dijkstra from row ``free_row`` to the nearest free column (jv.py:180)."""
    n = C.shape[-1]
    pred0 = torch.full((n,), free_row, dtype=INT, device=C.device)
    return _dijkstra_to_free_col(C, row_of_col, v, C[free_row] - v, pred0, stats)


def _multisource_path(
    C: torch.Tensor, free_row: torch.Tensor, row_of_col: List[int], v: torch.Tensor,
    stats: SolveStats,
) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Dijkstra from every free row at once (jv.py:276): each free row is
    normalised by its implicit potential min_j (C_fj - v_j), so each reaches
    some column at distance 0; first-index argmin for the predecessor."""
    inf = float("inf")
    red = C - v[None, :]
    u_free = torch.where(free_row[:, None], red, inf).amin(1)
    norm = torch.where(free_row[:, None], red - u_free[:, None], inf)
    d0, pred0 = torch.min(norm, dim=0)
    return _dijkstra_to_free_col(C, row_of_col, v, d0, pred0, stats)


def _flip_path_host(
    x: List[int], y: List[int], pred: List[int], final_j: int, stop_row: Optional[int]
) -> int:
    """Flip the alternating path ending at ``final_j`` in place, at most n + 1
    steps (jv.py:193, :300): until the row ``stop_row`` is reached, or, with
    ``stop_row`` None, a row that was free.  Negative indices wrap, as JAX's
    indexing normalises them (a search that found nothing has final_j = -1).
    Returns the steps walked."""
    n = len(pred)
    j, done, k = final_j, False, 0
    while not done and k <= n:
        i = pred[j]
        y[j] = i
        next_j = x[i]
        x[i] = j
        done = next_j < 0 if stop_row is None else i == stop_row
        k += 1
        j = next_j
    return k


def _flip_round(
    m: Matching, v: torch.Tensor, final_j: int, pred: torch.Tensor,
    stop_row: Optional[int], stats: SolveStats,
) -> Matching:
    xs, ys, ps = stats.to_host(torch.stack([m.col_of_row, m.row_of_col, pred.to(INT)]))
    stats.flip_steps += _flip_path_host(xs, ys, ps, final_j, stop_row)
    xy = stats.to_device([xs, ys], m.col_of_row)
    return Matching(xy[0], xy[1], v)


def _one_path_round(C: torch.Tensor, m: Matching, stats: SolveStats) -> Matching:
    """One free row (the first) augmented along its shortest path (jv.py:248)."""
    free_row = _argmin_host(m.col_of_row, stats)
    y = stats.to_host(m.row_of_col)
    final_j, pred, v = _find_augmenting_path(C, free_row, y, m.v, stats)
    return _flip_round(m, v, final_j, pred, free_row, stats)


def _one_multisource_round(C: torch.Tensor, m: Matching, stats: SolveStats) -> Matching:
    """The nearest free column from any free row, flipped back to the free
    row its path reaches (jv.py:255)."""
    y = stats.to_host(m.row_of_col)
    final_j, pred, v = _multisource_path(C, m.col_of_row < 0, y, m.v, stats)
    return _flip_round(m, v, final_j, pred, None, stats)


def augment_all(C: torch.Tensor, m: Matching, stats: Optional[SolveStats] = None) -> Matching:
    """Shortest augmenting path for one free row at a time until none is
    free, at most n + 1 rounds (jv.py:262)."""
    stats = SolveStats() if stats is None else stats
    return _bounded_augment_loop(m, C.shape[-1], lambda m: _one_path_round(C, m, stats), stats)


def augment_all_multisource(
    C: torch.Tensor, m: Matching, stats: Optional[SolveStats] = None
) -> Matching:
    """One multi-source search and flip a round until no row is free, at most
    n + 1 rounds (jv.py:329)."""
    stats = SolveStats() if stats is None else stats
    return _bounded_augment_loop(
        m, C.shape[-1], lambda m: _one_multisource_round(C, m, stats), stats
    )


def _sweep_shortest_paths(
    red: torch.Tensor,
    free_row: torch.Tensor,
    x_safe: torch.Tensor,
    d0: torch.Tensor,
    pred0: torch.Tensor,
    max_sweeps: int,
    free_col: Optional[torch.Tensor] = None,
    stats: Optional[SolveStats] = None,
    part: RowPartition = WHOLE,
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
        best, best_i = part.argmin(e[:, None] + red)
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
    xs, ys, pred, cs = stats.to_host(torch.stack([x, y, pred_row.to(INT), cand.to(INT)]))
    stats.flip_steps += _flip_disjoint_paths_host(xs, ys, pred, cs)
    xy = stats.to_device([xs, ys], x)
    return xy[0], xy[1]


def augment_all_sweep(
    C: torch.Tensor,
    m: Matching,
    stats: Optional[SolveStats] = None,
    part: RowPartition = WHOLE,
) -> Matching:
    """Augment free rows by min-plus sweep shortest paths, a tie group of
    paths per round (jv.py:533): implicit row potentials, clamped reduced
    costs, sweeps from all free rows at once, the settled-set dual update
    v += min(d, delta) - delta, then the disjoint-path flip of every free
    column within a few ulps of delta.  A CUDA tensor whose partition holds
    every row launches kernel S1 (or raises); a CPU tensor, or a row block
    of several ranks, runs the eager loop."""
    stats = SolveStats() if stats is None else stats
    if C.device.type == "cpu" or part.size > 1:
        return _augment_all_sweep_eager(C, m, stats, part)
    counts = stats.device_counts(C.device)[2:]
    return Matching(*augment_sweep(C, m.col_of_row, m.row_of_col, m.v, counts))


def _augment_all_sweep_eager(
    C: torch.Tensor, m: Matching, stats: SolveStats, part: RowPartition = WHOLE
) -> Matching:
    """``augment_all_sweep`` as eager PyTorch, every loop condition read on
    the host and the flips walked there: the CPU path, the sharded path and
    S1's plain version."""
    n = C.shape[-1]
    inf = float("inf")
    eps8 = 8.0 * torch.finfo(C.dtype).eps

    def body(m: Matching) -> Matching:
        x, y, v = m
        x_loc = part.local(x)
        free_row = x_loc < 0
        free_col = y < 0
        slack = C - v[None, :]
        x_safe = torch.where(x_loc >= 0, x_loc, 0)
        u_matched = slack.gather(1, x_safe[:, None])[:, 0]
        u_free = slack.amin(1)
        u = torch.where(free_row, u_free, u_matched)
        red = slack - u[:, None]
        # jnp.maximum(red, 0.0): +0.0 for either zero, NaN propagates
        red = torch.where(red <= 0, 0.0, red)
        src = torch.where(free_row[:, None], red, inf)
        d0, pred0 = part.argmin(src)
        d, pred_row = _sweep_shortest_paths(
            red, free_row, x_safe, d0, pred0, n, free_col, stats, part
        )
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
    part: RowPartition = WHOLE,
) -> Matching:
    """Exactness polish (jv.py:602): unmatch every row whose matched slack
    exceeds its row minimum by more than the threshold, re-augment exactly."""
    n = C.shape[-1]
    iota = torch.arange(n, dtype=INT, device=C.device)
    x, y, v = m
    x_loc = part.local(x)
    slack = C - v[None, :]
    x_safe = torch.where(x_loc >= 0, x_loc, 0)
    matched_slack = slack.gather(1, x_safe[:, None])[:, 0]
    viol = torch.where(x_loc >= 0, matched_slack - slack.amin(1), 0.0)
    if eps is None:
        eps = 8.0 * torch.finfo(C.dtype).eps
        threshold = eps * (1.0 + part.max(C.abs().max()))
    else:
        threshold = torch.tensor(eps, dtype=C.dtype, device=C.device)
    bad = part.gather(viol > threshold)
    x_new = torch.where(bad, -1, x)
    y_new = torch.full((n + 1,), -1, dtype=INT, device=C.device).scatter_reduce_(
        0, torch.where(x_new >= 0, x_new, n), torch.where(x_new >= 0, iota, -1), "amax"
    )[:n]
    return augment_all_sweep(C, Matching(x_new, y_new, v), stats, part)


def lapjv_single(
    C: torch.Tensor, stats: Optional[SolveStats] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve one dense square LAP cold.  Returns (col_of_row, row_of_col,
    cost).  On a GPU the matrix is float32 or float64 (the kernels S2 and
    S1 run the ARR rounds and the augmentation)."""
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
