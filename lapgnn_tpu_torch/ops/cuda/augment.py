"""S1 min-plus sweep augmentation of the device solver: CUDA kernel and plain version.

Replaces ``lapgnn_tpu/solver/jv.py:augment_all_sweep`` (:533), whose rounds
(:223), sweeps (:346) and flips (:437, :410) are ``lax.while_loop``s that XLA
runs on the device; no Pallas kernel stands behind them.  The kernel
(``csrc/augment.cu``) runs every round in one cooperative launch: the row
potentials, the free rows' column minima, the sweeps, the dual update, the
candidates and the disjoint-path flip, with no read by the host.  It serves
``solver.jv.augment_all_sweep`` and so ``polish_matching``, which
re-augments.

Design (the reasons are in the source): columns are cut into tiles that one
block each reduces over every row, so the column minimum and its first row
need no combine across blocks and float64 takes the same code; each sweep
ends in one hand-written grid barrier (``csrc/grid_barrier.cuh``) that
carries its stop test as three words of order-preserving integer keys
(``sweep_stop_by_keys``); the flip is a serial pointer walk on one warp.
Three layouts, chosen by ``augment_layout`` from n, the type and the SM
count:

- resident (``augment_resident``: n up to 2,508 in float32, 1,729 in
  float64 on 132 SMs): each block keeps one tile of C, any width from 8 to
  32 columns (``resident_tile``), in its shared memory for the whole launch,
  loaded each round by TMA (``resident_tma_rows``) or coalesced loads, with
  red written in its place; a sweep gathers e from a shared copy of d and
  takes only the rows whose e changed (``sweeps_by_frontier``);
- staged (``augment_staged``: up to 19,370 / 11,622): the round's u and x
  and the sweep's e in shared memory, C read through L2 each pass;
- unstaged (above): u, x and e read through L2, one more grid sync a sweep,
  so every n the card can hold C for is solved.

``augment_geometry`` is the launch the wrapper hands to the kernel; a
resident launch the card cannot hold raises, and nothing falls back to
another layout.

Bound on this card: while C fits in L2 (n = 2048), one read of C from
device memory and the sweeps' float operations (C is re-read on chip); above
L2, C read once a sweep, ``sweeps * n * n * itemsize`` at 3.35 TB/s.

The plain version is the eager loop ``solver.jv._augment_all_sweep_eager``
(every loop condition read on the host, the flips walked over Python
lists); the kernel equals it bit for bit (x, y, v and the loop counts).  A
CUDA tensor launches the kernel (or raises); only a CPU tensor takes the
plain version.  The wrapper counts its kernel launches in the tracer's
``launch.augment_sweep``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "CoopGeometry",
    "LAYOUTS",
    "augment_geometry",
    "augment_layout",
    "augment_resident",
    "augment_smem_bytes",
    "augment_staged",
    "augment_sweep",
    "augment_sweep_kernel",
    "augment_sweep_plain",
    "barrier_bench",
    "column_min_by_tiles",
    "flip_paths_by_arrays",
    "resident_tile",
    "resident_tma_rows",
    "stop_keys",
    "sweep_stop_by_keys",
    "sweeps_by_frontier",
]

THREADS = 256  # csrc/augment.cu's kThreads
TILES = (32, 16, 8)  # columns a tile (staged and unstaged), widest first
RESIDENT_TILES = (8, 32)  # a resident tile's least and largest width
MAX_SMEM = 232_448  # an H100's shared memory a block
L2_BYTES = 50 * 2**20  # an H100's L2
LAYOUTS = ("unstaged", "staged", "resident")  # csrc/augment.cu's Layout, in order
TMA_MAX_ROWS = 256  # rows of a TMA box at most
TMA_ALIGN = 128  # a TMA destination's alignment in shared memory


def _align16(b: int) -> int:
    return (b + 15) & ~15


def resident_static_smem(itemsize: int) -> int:
    """An upper bound of the kernel's static shared memory: the row groups'
    (value, row) pairs, the flip's two paths, the stop test's words, the
    tile's mbarrier, its columns' NaN flags and the warps' counts of
    changed rows (``lapgnn_augment_static_smem`` reads the real figure on
    the card)."""
    return 1792 + THREADS * itemsize


@dataclass(frozen=True)
class CoopGeometry:
    """A cooperative launch: ``blocks`` blocks of ``threads`` threads, every
    one resident at once; ``tile`` columns a tile (S1); ``smem_bytes`` of
    dynamic shared memory a block (S1: 0 for the unstaged layout)."""

    blocks: int
    threads: int
    tile: int
    smem_bytes: int


def resident_tile(n: int, sms: int) -> int:
    """The resident layout's tile: one a block, as many columns as spread n
    over the SMs, at least 8 (fewer, wider blocks make a barrier cheaper)."""
    return max(RESIDENT_TILES[0], -(-n // sms))


def augment_smem_bytes(n: int, itemsize: int, layout: str = "staged", tile: int = 0) -> int:
    """A block's dynamic shared memory.  Resident: 128 bytes of slack to
    align the tile for TMA, the tile of ``tile`` columns, d (the changed
    rows' list once e is gathered), e (u before the sweeps), x as int and a
    bit a row; staged: the round's u and x and the sweep's e; unstaged:
    none."""
    if layout == "resident":
        return (TMA_ALIGN + _align16(itemsize * n * tile) + 2 * _align16(itemsize * n)
                + _align16(4 * n) + _align16(4 * (-(-n // 32))))
    return (2 * itemsize + 4) * n if layout == "staged" else 0


def augment_resident(n: int, itemsize: int, sms: int) -> bool:
    """Whether a block can keep its tile of C in shared memory for the whole
    launch: the tile at most 32 columns wide (its owners are one warp), and
    the tile, d, e, x and a bit a row within ``MAX_SMEM`` beside the static
    shared memory."""
    tile = resident_tile(n, sms)
    return (tile <= RESIDENT_TILES[1]
            and augment_smem_bytes(n, itemsize, "resident", tile) + resident_static_smem(itemsize)
            <= MAX_SMEM)


def augment_staged(n: int, itemsize: int) -> bool:
    """Whether a block stages the round's u and x and the sweep's e in its
    shared memory: where they fit in ``MAX_SMEM``.  Above, the kernel reads
    them from device memory through L2."""
    return augment_smem_bytes(n, itemsize) <= MAX_SMEM


def augment_layout(n: int, itemsize: int, sms: int) -> str:
    """The first layout that fits: resident, staged, unstaged."""
    if augment_resident(n, itemsize, sms):
        return "resident"
    return "staged" if augment_staged(n, itemsize) else "unstaged"


def resident_tma_rows(n: int, itemsize: int, tile: int) -> int:
    """Rows of the TMA boxes that load a resident tile, 0 where TMA cannot:
    rows of C and the tile's width each a multiple of 16 bytes, and a box of
    at most 256 rows that divides n and fills a multiple of 128 bytes (each
    box lands 128-byte aligned).  The largest such box."""
    if (n * itemsize) % 16 or (tile * itemsize) % 16:
        return 0
    for rows in range(min(TMA_MAX_ROWS, n), 0, -1):
        if n % rows == 0 and (rows * tile * itemsize) % TMA_ALIGN == 0:
            return rows
    return 0


def augment_geometry(n: int, itemsize: int, sms: int, occupancy: int, layout: str) -> CoopGeometry:
    """The launch for rows of n columns in the given layout (``occupancy``
    is the kernel's for that layout).  Resident: one block a tile
    (``resident_tile``), every block on an SM of its own, or a RuntimeError.
    Staged and unstaged: ``coop_blocks`` blocks, no more than there are
    tiles of 8 columns, and the widest tile that still gives every block a
    tile; a matrix that fits in L2 takes one block a SM (a sweep is short
    there, and fewer blocks make its barrier cheaper), a larger one two (more
    loads in flight from device memory), as measured on an H100."""
    from ._lib import coop_blocks

    if layout == "resident":
        if not augment_resident(n, itemsize, sms):
            raise ValueError(f"augment: n = {n} ({itemsize}-byte) does not fit the resident "
                             f"layout on {sms} SMs")
        tile = resident_tile(n, sms)
        blocks = -(-n // tile)
        if coop_blocks(occupancy, sms, blocks, 1) != blocks:
            raise RuntimeError(f"augment: the card holds {occupancy} resident block(s) an SM, "
                               f"not the {blocks} of n = {n}")
        return CoopGeometry(blocks=blocks, threads=THREADS, tile=tile,
                            smem_bytes=augment_smem_bytes(n, itemsize, layout, tile))
    smem = augment_smem_bytes(n, itemsize, layout)
    if smem > MAX_SMEM:
        raise ValueError(f"augment: n = {n} needs {smem} B of shared memory a block to stage, "
                         f"above {MAX_SMEM}")
    per_sm = 1 if n * n * itemsize <= L2_BYTES else 2
    blocks = coop_blocks(occupancy, sms, -(-n // TILES[-1]), per_sm)
    tile = next(t for t in TILES if -(-n // t) >= blocks)
    return CoopGeometry(blocks=blocks, threads=THREADS, tile=tile, smem_bytes=smem)


def _lex_less(a, ia, b, ib):
    """``lex_less`` of csrc/twomin.cuh: (value, index) order, NaN smallest."""
    an, bn = torch.isnan(a), torch.isnan(b)
    return torch.where(an | bn, an & (~bn | (ia < ib)), (a < b) | ((a == b) & (ia < ib)))


def column_min_by_tiles(
    val: torch.Tensor, tile: int, resident: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A plain transcription of the kernel's column minimum, for the CPU
    tests: the threads (col, rg) of a block stride the rows rg, rg + G, ...
    in order, then thread col merges the row groups under ``lex_less``.
    Staged and unstaged (``tile_min``): G = THREADS / tile, each thread
    keeping the least (value, row) under ``lex_less``; the result is
    ``torch.min(val, dim=0)``'s.  Resident (the sweep): G = min(THREADS /
    tile, n), each thread keeping the least value by a strict ``<`` (so its
    first row of a tie, NaN left out), and a column with a NaN takes NaN
    from the round's flag: the values are ``torch.min``'s, and so are the
    rows of every minimum but NaN and +inf, which never improve a distance
    and whose rows are never read."""
    n, m = val.shape
    groups = min(THREADS // tile, n) if resident else THREADS // tile
    best = val.new_full((groups, m), float("inf"))
    row = torch.full((groups, m), 0x7FFFFFFF, dtype=torch.int64)
    for i in range(n):
        g = i % groups
        if resident:
            take = val[i] < best[g]
        else:
            take = _lex_less(val[i], torch.tensor(i), best[g], row[g])
        best[g] = torch.where(take, val[i], best[g])
        row[g] = torch.where(take, i, row[g])
    out_v, out_i = best[0], row[0]
    for g in range(1, groups):
        take = _lex_less(best[g], row[g], out_v, out_i)
        out_v = torch.where(take, best[g], out_v)
        out_i = torch.where(take, row[g], out_i)
    if resident:
        out_v = torch.where(torch.isnan(val).any(0), float("nan"), out_v)
    return out_v, out_i


def sweeps_by_frontier(
    red: torch.Tensor, free_row: torch.Tensor, x_safe: torch.Tensor, d0: torch.Tensor,
    pred0: torch.Tensor, free_col: torch.Tensor, max_sweeps: int,
    changed: Optional[list] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """A plain transcription of the resident layout's sweeps, for the CPU
    tests: each sweep gathers e and takes only the rows whose e changed
    since the last sweep (every row with a finite e in the first), the
    least e_i + red_ik over them and its lowest row; a column with a NaN in
    red, or any NaN in e, improves nothing.  The stop test is the plain
    loop's.  Returns (d, pred, sweeps), to be held against
    ``solver.jv._sweep_shortest_paths``; appends each sweep's number of
    changed rows to ``changed`` where one is given."""
    inf = float("inf")
    tol = 8.0 * torch.finfo(red.dtype).eps
    col_nan = torch.isnan(red).any(0)
    d, pred = d0.clone(), pred0.clone()
    e_old = torch.full_like(d0, inf)
    sweeps = 0
    while True:
        e = torch.where(free_row, inf, d[x_safe])
        rows = torch.nonzero(~(e == e_old)).flatten()
        e_old = e
        if changed is not None:
            changed.append(rows.numel())
        improve = torch.zeros_like(free_col)
        if rows.numel() and not bool(torch.isnan(e).any()):
            val = e[rows, None] + red[rows]
            val = torch.where(torch.isnan(val), inf, val)
            best, at = torch.min(val, dim=0)  # torch.min: the first row of a tie
            improve = ~col_nan & (best < d)
            d = torch.where(improve, best, d)
            pred = torch.where(improve, rows[at], pred)
        dmin_free = torch.where(free_col, d, inf).amin()
        thresh = dmin_free + tol * (1.0 + dmin_free.abs())
        sweeps += 1
        if not (bool((improve & (d <= thresh)).any()) and sweeps <= max_sweeps):
            return d, pred, sweeps


_TOP = 1 << 63
_INF_KEY = 0xFFF0000000000000  # the key of +inf


def stop_keys(d: torch.Tensor) -> list:
    """The stop test's order key of each distance (``stop_key``), as Python
    ints: 0 for NaN; else the value widened to double, its bits with the
    sign bit set when positive and every bit inverted when negative."""
    bits = d.double().numpy().view(np.uint64).tolist()
    nan = torch.isnan(d).tolist()
    return [0 if z else ((~b & (2**64 - 1)) if b & _TOP else b | _TOP)
            for b, z in zip(bits, nan)]


def _stop_value(key: int, dtype: torch.dtype) -> torch.Tensor:
    """``stop_value``: the distance of a key (0: NaN)."""
    if key == 0:
        return torch.tensor(float("nan"), dtype=dtype)
    bits = key ^ _TOP if key & _TOP else ~key & (2**64 - 1)
    return torch.tensor(np.array([bits], np.uint64).view(np.float64)[0], dtype=dtype)


def sweep_stop_by_keys(
    d: torch.Tensor, improve: torch.Tensor, free_col: torch.Tensor, blocks: int, tile: int
) -> Tuple[bool, torch.Tensor]:
    """A plain transcription of the kernel's sweep stop test, for the CPU
    tests: block b owns the tiles b, b + blocks, ... (resident: its one
    tile); warp 0 folds the block's columns into keys (``stop_keys``) of
    the least new d over the free columns and over the improved columns,
    and whether one improved; atomic minima and an or over the blocks give
    the three words every block reads after the barrier: another sweep iff
    some column improved and the least improved d is at most dmin_free +
    8 eps (1 + |dmin_free|).  Returns (another sweep, dmin_free)."""
    n = d.shape[0]
    keys = stop_keys(d)
    words = [_INF_KEY, _INF_KEY, 0]
    for b in range(blocks):
        mine = [k for k in range(n) if (k // tile) % blocks == b]
        kf = min([keys[k] for k in mine if free_col[k]], default=_INF_KEY)
        km = min([keys[k] for k in mine if improve[k]], default=_INF_KEY)
        words = [min(words[0], kf), min(words[1], km),
                 words[2] | int(any(bool(improve[k]) for k in mine))]
    dmin_free = _stop_value(words[0], d.dtype)
    least_imp = _stop_value(words[1], d.dtype)
    tol = 8.0 * torch.finfo(d.dtype).eps
    thresh = dmin_free + tol * (1.0 + dmin_free.abs())
    return bool(words[2]) and bool(least_imp <= thresh), dmin_free


def flip_paths_by_arrays(x, y, pred, cand) -> int:
    """A plain transcription of the kernel's flips (``flip_paths``) over
    numpy int64 arrays, in place, for the CPU tests: the candidates in
    ascending order 32 at a time (one ballot each), each path walked at most
    64 hops and committed only when complete and clear of the rows used
    this round; when nothing flipped, the first candidate's path uncapped
    (n + 1 steps at most).  Returns the steps walked."""
    n = len(pred)
    used = [False] * n
    steps, first, flipped = 0, -1, False
    for base in range(0, n, 32):
        for j0 in [j for j in range(base, min(base + 32, n)) if cand[j]]:
            if first < 0:
                first = j0
            rows, cols, j, ok, done = [], [], j0, True, False
            while not done and ok and len(rows) < 64:
                i = int(pred[j])
                ok = not used[i]
                rows.append(i)
                cols.append(j)
                nj = int(x[i])
                done, j = nj < 0, nj
            steps += len(rows)
            if ok and done:
                for i, jj in zip(rows, cols):
                    x[i], y[jj], used[i] = jj, i, True
                flipped = True
    if first >= 0 and not flipped:
        j, k, done = first, 0, False
        while not done and k <= n:
            i = int(pred[j])
            nj = int(x[i])
            y[j], x[i] = i, j
            done, k, j = nj < 0, k + 1, nj
        steps += k
    return steps


def augment_sweep_plain(
    C: torch.Tensor, x: torch.Tensor, y: torch.Tensor, v: torch.Tensor, counts: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The eager ``augment_all_sweep`` on (C, x, y, v); adds its rounds,
    sweeps and flip steps to ``counts`` (3 int64 on C's device)."""
    from ...solver.jv import Matching, SolveStats, _augment_all_sweep_eager

    stats = SolveStats()
    m = _augment_all_sweep_eager(C, Matching(x, y, v), stats)
    counts += torch.tensor([stats.aug_rounds, stats.sweeps, stats.flip_steps],
                           dtype=counts.dtype, device=counts.device)
    return m.col_of_row, m.row_of_col, m.v


def _check(C, x, y, v, counts, slots: int = 3, what: str = "augment") -> None:
    """The solver state's checks, shared by S1 and S2: square contiguous C,
    (n,) int64 x and y, (n,) v of C's dtype, ``slots`` contiguous int64
    counts, all on C's device."""
    if C.dtype not in (torch.float32, torch.float64) or v.dtype != C.dtype:
        raise TypeError(f"{what}: C and v must both be float32 or float64, got {C.dtype}, {v.dtype}")
    if C.ndim != 2 or C.shape[0] != C.shape[1] or C.shape[0] < 1:
        raise ValueError(f"{what}: takes a square (n, n) C, got {tuple(C.shape)}")
    n = C.shape[0]
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.int64 or tuple(t.shape) != (n,):
            raise ValueError(f"{what}: {name} must be ({n},) int64, got {t.dtype} {tuple(t.shape)}")
    if tuple(v.shape) != (n,):
        raise ValueError(f"{what}: v must be ({n},), got {tuple(v.shape)}")
    if counts.dtype != torch.int64 or counts.numel() < slots or not counts.is_contiguous():
        raise ValueError(f"{what}: counts must be {slots} contiguous int64")
    if any(t.device != C.device for t in (x, y, v, counts)):
        raise ValueError(f"{what}: every tensor must be on C's device")
    if not C.is_contiguous():
        raise ValueError(f"{what}: C must be contiguous")


_OCCUPANCY: Dict[Tuple[int, int, int, int, int], int] = {}


def augment_sweep_kernel(
    C: torch.Tensor, x: torch.Tensor, y: torch.Tensor, v: torch.Tensor, counts: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors: new (x, y, v); the inputs are not changed."""
    return _augment(C, x, y, v, counts)


def _occupancy(lib, device: torch.device, n: int, f64: int, layout: str, tile: int) -> int:
    key = (device.index, n, f64, LAYOUTS.index(layout), tile)
    if key not in _OCCUPANCY:
        _OCCUPANCY[key] = lib.lapgnn_augment_occupancy(n, f64, LAYOUTS.index(layout), tile)
    return _OCCUPANCY[key]


def _augment(C, x, y, v, counts, layout: Optional[str] = None, tma: bool = True):
    """The kernel in ``augment_layout``'s layout, or in the one given, so
    that a layout also runs where a larger one fits, to hold them against
    each other; ``tma=False`` loads a resident tile by coalesced loads where
    TMA could.  A layout the card cannot hold raises."""
    if C.device.type != "cuda":
        raise ValueError(f"augment: unsupported device {C.device}")
    _check(C, x, y, v, counts)
    from ._lib import KERNEL_LIBS, launched, ptr, sm_count, stream_ptr

    n, f64, itemsize = C.shape[0], int(C.dtype == torch.float64), C.element_size()
    sms = sm_count(C.device)
    layout = augment_layout(n, itemsize, sms) if layout is None else layout
    if layout not in LAYOUTS:
        raise ValueError(f"augment: unknown layout {layout!r}")
    lib = KERNEL_LIBS["augment"].load()
    with torch.cuda.device(C.device):
        tile = resident_tile(n, sms) if layout == "resident" else 0
        occ = _occupancy(lib, C.device, n, f64, layout, tile)
        g = augment_geometry(n, itemsize, sms, occ, layout)
        rows = 0
        if layout == "resident" and tma and C.data_ptr() % 16 == 0:
            rows = resident_tma_rows(n, itemsize, g.tile)
        x, y, v = x.clone(), y.clone(), v.clone()
        work = torch.empty(lib.lapgnn_augment_work_bytes(n, g.blocks, f64), dtype=torch.uint8,
                           device=C.device)
        launch = lib.lapgnn_augment_f64 if f64 else lib.lapgnn_augment
        rc = launch(ptr(C), ptr(x), ptr(y), ptr(v), ptr(work), ptr(counts), n, g.blocks, g.tile,
                    LAYOUTS.index(layout), rows, 8.0 * torch.finfo(C.dtype).eps,
                    stream_ptr(C.device))
    launched(rc, f"augment kernel ({layout})", "augment_sweep")
    return x, y, v


def barrier_bench(device: torch.device, geometry: CoopGeometry, iters: int,
                  payload: bool = False) -> None:
    """``iters`` grid barriers of the sweep's kind alone, on ``geometry``'s
    grid (its blocks, threads and shared memory), with or without the stop
    test's atomics, reset and read: one launch on the current stream, for
    timing the sweeps' sync floor.  Not a path of the solver."""
    from ._lib import KERNEL_LIBS, check, ptr, stream_ptr

    lib = KERNEL_LIBS["augment"].load()
    with torch.cuda.device(device):
        work = torch.zeros(lib.lapgnn_augment_barrier_work_bytes(), dtype=torch.uint8,
                           device=device)
        rc = lib.lapgnn_augment_barrier_bench(geometry.blocks, geometry.smem_bytes, iters,
                                              int(payload), ptr(work), stream_ptr(device))
    check(rc, "augment barrier bench")


def augment_sweep(
    C: torch.Tensor, x: torch.Tensor, y: torch.Tensor, v: torch.Tensor, counts: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """S1: augment the matching (x, y, v) of square C until no row is free
    (at most n + 1 rounds); adds the rounds, sweeps and flip steps to
    ``counts``.  A CPU tensor takes the plain version; any other launches
    the kernel, which raises for a dtype other than float32 and float64."""
    if C.device.type == "cpu":
        return augment_sweep_plain(C, x, y, v, counts)
    return augment_sweep_kernel(C, x, y, v, counts)
