"""S2 Jacobi augmenting row reduction of the device solver: CUDA kernel and plain version.

Replaces ``lapgnn_tpu/solver/seeded.py:jacobi_arr`` (:163), a
``lax.while_loop`` of auction rounds that XLA runs on the device; only its
bid had a Pallas kernel (K4, ``ops.cuda.two_min``).  The kernel
(``csrc/arr.cu``) runs every round in one cooperative launch, up to
``max_rounds`` or the first round that wins nothing: each free row's bid by
K4's own device code (``csrc/twomin.cuh``, so the same bits as K4), each
column's largest gap with the lowest row on a tie (``RowPartition.best_bid``'s
rule) by a 64-bit keyed atomicMax and a row atomicMin, then v lowered, the
kick and the assignment.  ``arr_blocks`` sizes its grid.

Bound on this card: device-memory bytes, C read once a round:
``rounds * n * n * itemsize`` at 3.35 TB/s (only the free rows are read, so
the real reads are fewer); at the solver's size C stays in L2, and a round
is three grid syncs and the free rows' scans.

The plain version is the eager loop ``solver.seeded._jacobi_arr_eager`` with
K4's plain version as the bid; the kernel equals it bit for bit (x, y, v and
the rounds).  A CUDA tensor launches the kernel (or raises); only a CPU
tensor takes the plain version.  The wrapper counts its kernel launches in
``.launches``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .augment import _check as _check_state

__all__ = [
    "arr_auction",
    "arr_auction_kernel",
    "arr_auction_plain",
    "arr_blocks",
    "best_bid_by_keys",
    "gap_keys",
]

WARPS_PER_BLOCK = 8  # csrc/arr.cu: a warp a row, 256 threads


def arr_blocks(n: int, sms: int, occupancy: int) -> int:
    """The cooperative grid: ``coop_blocks``, no more blocks than rows of
    eight warps."""
    from ._lib import coop_blocks

    return coop_blocks(occupancy, sms, -(-n // WARPS_PER_BLOCK))


_TOP = np.uint64(1 << 63)


def gap_keys(gaps: torch.Tensor) -> np.ndarray:
    """The kernel's order key of each gap (``gap_key``), as uint64: the gap
    as a double plus 0.0 (-0.0 becomes +0.0), its bits with the sign bit set
    when positive and all bits inverted when negative."""
    bits = (gaps.double() + 0.0).numpy().view(np.uint64)
    return np.where(bits & _TOP, ~bits, bits | _TOP)


def best_bid_by_keys(
    cols: torch.Tensor, gaps: torch.Tensor, rows: torch.Tensor, n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A plain transcription of the kernel's auction, for the CPU tests, in
    ``RowPartition.best_bid``'s form: row ``rows[k]`` bids ``gaps[k]`` for
    column ``cols[k]`` (n for none).  Each column's largest key by a max (0
    for none), then the lowest row among the bids whose key reaches it by a
    min (n for none); the gap decoded from the key.  Over n + 1 slots."""
    keys = gap_keys(gaps)
    c = cols.numpy()
    best = np.zeros(n + 1, np.uint64)
    bid = c < n
    np.maximum.at(best, c[bid], keys[bid])
    win = np.full(n + 1, n, np.int64)
    cand = bid & (keys >= best[np.minimum(c, n)])
    np.minimum.at(win, c[cand], rows.numpy()[cand])
    gap_bits = np.where(best & _TOP, best ^ _TOP, ~best).view(np.float64)
    col_best = np.where(best != 0, gap_bits, -np.inf).astype(gaps.numpy().dtype)
    return torch.from_numpy(col_best), torch.from_numpy(win)


def arr_auction_plain(
    C: torch.Tensor, x: torch.Tensor, y: torch.Tensor, v: torch.Tensor, max_rounds: int,
    min_delta: float, counts: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The eager ``jacobi_arr`` on (C, x, y, v) with ``two_min_plain`` as the
    bid; adds its rounds to ``counts`` (1 int64 on C's device)."""
    from ...solver.jv import Matching, SolveStats
    from ...solver.seeded import _jacobi_arr_eager
    from .twomin import two_min_plain

    stats = SolveStats()
    m = _jacobi_arr_eager(C, Matching(x, y, v), max_rounds, min_delta, stats, bid=two_min_plain)
    counts += torch.tensor([stats.arr_rounds], dtype=counts.dtype, device=counts.device)
    return m.col_of_row, m.row_of_col, m.v


_OCCUPANCY: Dict[Tuple[int, int, int], int] = {}


def arr_auction_kernel(
    C: torch.Tensor, x: torch.Tensor, y: torch.Tensor, v: torch.Tensor, max_rounds: int,
    min_delta: float, counts: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors: new (x, y, v); the inputs are not changed."""
    if C.device.type != "cuda":
        raise ValueError(f"arr: unsupported device {C.device}")
    _check_state(C, x, y, v, counts, 1, "arr")
    from ._lib import KERNEL_LIBS, check, ptr, sm_count, stream_ptr

    n, f64 = C.shape[0], int(C.dtype == torch.float64)
    lib = KERNEL_LIBS["arr"].load()
    with torch.cuda.device(C.device):
        x, y, v = x.clone(), y.clone(), v.clone()
        vec = int(not f64 and n % 4 == 0 and C.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0)
        key = (C.device.index, f64, vec)
        if key not in _OCCUPANCY:
            _OCCUPANCY[key] = lib.lapgnn_arr_occupancy(f64, vec)
        blocks = arr_blocks(n, sm_count(C.device), _OCCUPANCY[key])
        work = torch.empty(lib.lapgnn_arr_work_bytes(n, max_rounds, f64), dtype=torch.uint8,
                           device=C.device)
        if f64:
            rc = lib.lapgnn_arr_f64(ptr(C), ptr(x), ptr(y), ptr(v), ptr(work), ptr(counts), n,
                                    max_rounds, min_delta, blocks, stream_ptr(C.device))
        else:
            rc = lib.lapgnn_arr(ptr(C), ptr(x), ptr(y), ptr(v), ptr(work), ptr(counts), n,
                                max_rounds, min_delta, vec, blocks, stream_ptr(C.device))
    check(rc, "arr kernel")
    arr_auction.launches += 1
    return x, y, v


def arr_auction(
    C: torch.Tensor, x: torch.Tensor, y: torch.Tensor, v: torch.Tensor, max_rounds: int,
    min_delta: float, counts: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """S2: Jacobi-ARR rounds on the matching (x, y, v) of square C until a
    round wins nothing or ``max_rounds``; adds the rounds to ``counts``.  A
    CPU tensor takes the plain version; any other launches the kernel, which
    raises for a dtype other than float32 and float64."""
    if C.device.type == "cpu":
        return arr_auction_plain(C, x, y, v, max_rounds, min_delta, counts)
    return arr_auction_kernel(C, x, y, v, max_rounds, min_delta, counts)


arr_auction.launches = 0
