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
block each reduces over every row in row order, so the column minimum and
its first row need no combine across blocks and float64 takes the same
code; each sweep publishes per-block partials of its stop test and every
block reduces all of them after the sweep's one grid sync; red is
recomputed from C, v and u in each pass, never stored; the flip is a serial
pointer walk on one warp.  A block stages the round's u and x and the
sweep's e in its shared memory where they fit (``augment_staged``: n up to
19,370 in float32, 11,622 in float64); above, the kernel reads them from
device memory through L2, with one more grid sync a sweep, so every n the
card can hold C for is solved.  ``augment_geometry`` is the launch the
wrapper hands to the kernel.

Bound on this card: while C fits in L2 (n = 2048), one read of C from
device memory and the sweeps' float operations (C is re-read on chip); above
L2, C read once a sweep, ``sweeps * n * n * itemsize`` at 3.35 TB/s.

The plain version is the eager loop ``solver.jv._augment_all_sweep_eager``
(every loop condition read on the host, the flips walked over Python
lists); the kernel equals it bit for bit (x, y, v and the loop counts).  A
CUDA tensor launches the kernel (or raises); only a CPU tensor takes the
plain version.  The wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

__all__ = [
    "CoopGeometry",
    "augment_geometry",
    "augment_smem_bytes",
    "augment_staged",
    "augment_sweep",
    "augment_sweep_kernel",
    "augment_sweep_plain",
    "column_min_by_tiles",
    "flip_paths_by_arrays",
    "sweep_stop_by_partials",
]

THREADS = 256  # csrc/augment.cu's kThreads
TILES = (32, 16, 8)  # columns a tile, widest first
MAX_SMEM = 232_448  # an H100's shared memory a block
L2_BYTES = 50 * 2**20  # an H100's L2


@dataclass(frozen=True)
class CoopGeometry:
    """A cooperative launch: ``blocks`` blocks of ``threads`` threads, every
    one resident at once; ``tile`` columns a tile (S1); ``smem_bytes`` of
    dynamic shared memory a block (S1: 0 for the unstaged layout)."""

    blocks: int
    threads: int
    tile: int
    smem_bytes: int


def augment_smem_bytes(n: int, itemsize: int, staged: bool = True) -> int:
    """A block's dynamic shared memory: the round's u and x and the sweep's e
    when staged, none else."""
    return (2 * itemsize + 4) * n if staged else 0


def augment_staged(n: int, itemsize: int) -> bool:
    """Whether a block stages the round's u and x and the sweep's e in its
    shared memory: where they fit in ``MAX_SMEM``.  Above, the kernel reads
    them from device memory through L2."""
    return augment_smem_bytes(n, itemsize) <= MAX_SMEM


def augment_geometry(n: int, itemsize: int, sms: int, occupancy: int, staged: bool) -> CoopGeometry:
    """The launch for rows of n columns in the given layout (``occupancy``
    is the kernel's for that layout): ``coop_blocks`` blocks, no more than
    there are tiles of 8 columns, and the widest tile that still gives every
    block a tile.  A matrix that fits in L2 takes one block a SM (a sweep is
    short there, and fewer blocks make its grid sync cheaper), a larger one
    two (more loads in flight from device memory), as measured on an
    H100."""
    from ._lib import coop_blocks

    smem = augment_smem_bytes(n, itemsize, staged)
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


def column_min_by_tiles(val: torch.Tensor, tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A plain transcription of the kernel's column minimum (``tile_min``),
    for the CPU tests: the threads (col, rg) of a block stride the rows rg,
    rg + THREADS / tile, ... in order keeping the least (value, row) under
    ``lex_less``; then thread col merges the row groups in order.  (n, m) ->
    the values and first rows over dim 0, as ``torch.min(val, dim=0)``."""
    groups = THREADS // tile
    n, m = val.shape
    best = val.new_full((groups, m), float("inf"))
    row = torch.full((groups, m), 0x7FFFFFFF, dtype=torch.int64)
    for i in range(n):
        g = i % groups
        take = _lex_less(val[i], torch.tensor(i), best[g], row[g])
        best[g] = torch.where(take, val[i], best[g])
        row[g] = torch.where(take, i, row[g])
    out_v, out_i = best[0], row[0]
    for g in range(1, groups):
        take = _lex_less(best[g], row[g], out_v, out_i)
        out_v = torch.where(take, best[g], out_v)
        out_i = torch.where(take, row[g], out_i)
    return out_v, out_i


def _nan_min(t: torch.Tensor) -> torch.Tensor:
    return t.amin() if t.numel() else torch.tensor(float("inf"), dtype=t.dtype)


def sweep_stop_by_partials(
    d: torch.Tensor, improve: torch.Tensor, free_col: torch.Tensor, blocks: int, tile: int
) -> Tuple[bool, torch.Tensor]:
    """A plain transcription of the kernel's sweep stop test, for the CPU
    tests: block b owns the tiles b, b + blocks, ...; each publishes the
    least new d over its free columns (NaN-propagating), over its improved
    columns, and whether it improved one; every block then reduces all the
    partials: another sweep iff some column improved and the least improved
    d is at most dmin_free + 8 eps (1 + |dmin_free|).  Returns (another
    sweep, dmin_free)."""
    n = d.shape[0]
    owner = (torch.arange(n) // tile) % blocks
    part_free, part_imp, part_any = [], [], []
    for b in range(blocks):
        mine = owner == b
        part_free.append(_nan_min(d[mine & free_col]))
        part_imp.append(_nan_min(d[mine & improve]))
        part_any.append(bool((mine & improve).any()))
    dmin_free = _nan_min(torch.stack(part_free))
    least_imp = _nan_min(torch.stack(part_imp))
    tol = 8.0 * torch.finfo(d.dtype).eps
    thresh = dmin_free + tol * (1.0 + dmin_free.abs())
    return any(part_any) and bool(least_imp <= thresh), dmin_free


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


_OCCUPANCY: Dict[Tuple[int, int, int, bool], int] = {}


def augment_sweep_kernel(
    C: torch.Tensor, x: torch.Tensor, y: torch.Tensor, v: torch.Tensor, counts: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors: new (x, y, v); the inputs are not changed."""
    return _augment(C, x, y, v, counts)


def _augment(C, x, y, v, counts, staged: Optional[bool] = None):
    """The kernel in ``augment_staged``'s layout, or in the one given: the
    unstaged layout also runs where the staged one fits, to hold the two
    against each other."""
    if C.device.type != "cuda":
        raise ValueError(f"augment: unsupported device {C.device}")
    _check(C, x, y, v, counts)
    from ._lib import KERNEL_LIBS, check, ptr, sm_count, stream_ptr

    n, f64 = C.shape[0], int(C.dtype == torch.float64)
    if staged is None:
        staged = augment_staged(n, C.element_size())
    lib = KERNEL_LIBS["augment"].load()
    with torch.cuda.device(C.device):
        key = (C.device.index, n, f64, staged)
        if key not in _OCCUPANCY:
            _OCCUPANCY[key] = lib.lapgnn_augment_occupancy(n, f64, int(staged))
        g = augment_geometry(n, C.element_size(), sm_count(C.device), _OCCUPANCY[key], staged)
        x, y, v = x.clone(), y.clone(), v.clone()
        work = torch.empty(lib.lapgnn_augment_work_bytes(n, g.blocks, f64), dtype=torch.uint8,
                           device=C.device)
        launch = lib.lapgnn_augment_f64 if f64 else lib.lapgnn_augment
        rc = launch(ptr(C), ptr(x), ptr(y), ptr(v), ptr(work), ptr(counts), n, g.blocks, g.tile,
                    int(staged), 8.0 * torch.finfo(C.dtype).eps, stream_ptr(C.device))
    check(rc, "augment kernel")
    augment_sweep.launches += 1
    return x, y, v


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


augment_sweep.launches = 0
