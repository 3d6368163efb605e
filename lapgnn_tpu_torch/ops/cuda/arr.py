"""S2 Jacobi augmenting row reduction of the device solver: CUDA kernel and plain version.

Replaces ``lapgnn_tpu/solver/seeded.py:jacobi_arr`` (:163), a
``lax.while_loop`` of auction rounds that XLA runs on the device; only its
bid had a Pallas kernel (K4, ``ops.cuda.two_min``).  The kernel
(``csrc/arr.cu``) runs every round in one cooperative launch, up to
``max_rounds`` or the first round that wins nothing, with one grid barrier
a round in float32 (two in float64) that carries the stop test: each block
ranks the free rows from its own copy of the state and scans its share of
them with K4's own device code (``csrc/twomin.cuh``, so the same bits as
K4); a column's largest gap and lowest row on a tie
(``RowPartition.best_bid``'s rule) by one 64-bit atomicMax of a packed word
(``winner_words``; float64 by a key then a row, ``best_bid_by_keys``), each
bid also stored in the entry of its row's rank; every block then applies
the round's winning entries to its copy (``arr_rounds_by_ranks``
transcribes the rounds).  Two layouts
(``arr_layout``): resident (each block's v and y in its shared memory) up
to n = 28,436 in float32, 18,938 in float64 on 132 SMs, and global (in
device memory, a region a block) above.  ``arr_geometry`` is the launch.

Bound on this card: device-memory bytes, the free rows of C read once a
round: ``sum of free rows * n * itemsize`` at 3.35 TB/s; at the solver's
size C stays in L2, and a round is one grid barrier and the free rows'
scans.

The plain version is the eager loop ``solver.seeded._jacobi_arr_eager`` with
K4's plain version as the bid; the kernel equals it bit for bit (x, y, v and
the rounds).  A CUDA tensor launches the kernel (or raises); only a CPU
tensor takes the plain version.  The wrapper counts its kernel launches in
the tracer's ``launch.arr_auction``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .augment import MAX_SMEM, THREADS, CoopGeometry
from .augment import _check as _check_state

__all__ = [
    "LAYOUTS",
    "arr_auction",
    "arr_auction_kernel",
    "arr_auction_plain",
    "arr_blocks",
    "arr_geometry",
    "arr_layout",
    "arr_rounds_by_ranks",
    "arr_smem_bytes",
    "best_bid_by_keys",
    "gap_keys",
    "winner_words",
]

LAYOUTS = ("global", "resident")  # csrc/arr.cu's kGlobal, kResident
STATIC_SMEM = 512  # at least the kernel's static shared memory (lapgnn_arr_static_smem)
BUFFERS = 3  # csrc/free_rows.cuh's kRoundBuffers


def _align16(b: int) -> int:
    return (b + 15) & ~15


def arr_smem_bytes(n: int, itemsize: int, own_cap: int, layout: str) -> int:
    """A block's dynamic shared memory (``smem_bytes``): a bit a row, the
    block's rows of a round (``own_cap``), float64 their bids' keys and
    columns, and in the resident layout v and y (as int)."""
    b = _align16(4 * (-(-n // 32))) + _align16(4 * own_cap)
    if itemsize == 8:
        b += _align16(8 * own_cap) + _align16(4 * own_cap)
    if layout == "resident":
        b += _align16(itemsize * n) + _align16(4 * n)
    return b


def arr_state_stride(n: int, itemsize: int) -> int:
    """A block's v and y in device memory (global layout), rounded up to 256
    bytes as the kernel's ``state_stride``."""
    return (_align16(itemsize * n) + _align16(4 * n) + 255) & ~255


def arr_blocks(n: int, sms: int, occupancy: int) -> int:
    """The cooperative grid: ``coop_blocks``, one block a SM (fewer blocks
    make the round's barrier cheaper and each block applies every winner),
    no more blocks than rows."""
    from ._lib import coop_blocks

    return coop_blocks(occupancy, sms, n, 1)


def arr_fits(n: int, itemsize: int, layout: str, blocks: int) -> bool:
    """Whether a block's shared memory holds the layout at n on ``blocks``
    blocks, beside the static shared memory."""
    own_cap = -(-n // blocks)
    return arr_smem_bytes(n, itemsize, own_cap, layout) + STATIC_SMEM <= MAX_SMEM


def arr_layout(n: int, itemsize: int, sms: int) -> str:
    """Resident where each block's v and y fit in its shared memory on one
    block a SM, else global."""
    return "resident" if arr_fits(n, itemsize, "resident", min(sms, n)) else "global"


def arr_geometry(n: int, itemsize: int, sms: int, occupancy: int, layout: str) -> CoopGeometry:
    """The launch in the given layout (``occupancy`` is the kernel's for
    that layout's shared memory): ``arr_blocks`` blocks of 256 threads and
    the layout's dynamic shared memory; a layout that does not fit raises."""
    if layout not in LAYOUTS:
        raise ValueError(f"arr: unknown layout {layout!r}")
    blocks = arr_blocks(n, sms, occupancy)
    if not arr_fits(n, itemsize, layout, blocks):
        raise ValueError(f"arr: n = {n} ({itemsize}-byte) does not fit the {layout} layout "
                         f"on {blocks} blocks")
    return CoopGeometry(blocks=blocks, threads=THREADS, tile=0,
                        smem_bytes=arr_smem_bytes(n, itemsize, -(-n // blocks), layout))


_TOP = np.uint64(1 << 63)


def gap_keys(gaps: torch.Tensor) -> np.ndarray:
    """The float64 form's order key of each gap (``gap_key``), as uint64:
    the gap as a double plus 0.0 (-0.0 becomes +0.0), its bits with the
    sign bit set when positive and all bits inverted when negative."""
    bits = (gaps.double() + 0.0).numpy().view(np.uint64)
    return np.where(bits & _TOP, ~bits, bits | _TOP)


def _key_gaps(keys: np.ndarray) -> np.ndarray:
    """``key_gap``: the float64 gap of each key."""
    return np.where(keys & _TOP, keys ^ _TOP, ~keys).view(np.float64)


def _gap_keys32(gaps: torch.Tensor) -> np.ndarray:
    """The float32 form's order key of each gap (``gap_key32``), as uint64
    holding 32 bits."""
    bits = (gaps.float() + 0.0).numpy().view(np.uint32).astype(np.uint64)
    return np.where(bits & 0x80000000, ~bits & 0xFFFFFFFF, bits | 0x80000000).astype(np.uint64)


def _key_gaps32(keys: np.ndarray) -> np.ndarray:
    """``key_gap32``: the float32 gap of each key."""
    keys = keys.astype(np.uint64)
    bits = np.where(keys & 0x80000000, keys ^ 0x80000000, ~keys & 0xFFFFFFFF)
    return bits.astype(np.uint32).view(np.float32)


def winner_words(
    cols: torch.Tensor, gaps: torch.Tensor, rows: torch.Tensor, n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A plain transcription of the float32 kernel's auction, for the CPU
    tests, in ``RowPartition.best_bid``'s form: row ``rows[k]`` bids
    ``gaps[k]`` (float32) for column ``cols[k]`` (n for none).  Each bid is
    one 64-bit word, the gap's 32-bit order key above the inverted row, and
    a column's slot keeps the largest word (0 for none); the gap and the row
    decoded from it.  Over n + 1 slots."""
    c = cols.numpy()
    bid = c < n
    inv_row = ~rows.numpy().astype(np.uint64) & np.uint64(0xFFFFFFFF)
    words = (_gap_keys32(gaps) << np.uint64(32)) | inv_row
    slot = np.zeros(n + 1, np.uint64)
    np.maximum.at(slot, c[bid], words[bid])
    got = slot != 0
    col_best = np.where(got, _key_gaps32(slot >> np.uint64(32)), -np.inf).astype(np.float32)
    win = np.where(got, (~slot & np.uint64(0xFFFFFFFF)).astype(np.int64), n)
    return torch.from_numpy(col_best), torch.from_numpy(win)


def best_bid_by_keys(
    cols: torch.Tensor, gaps: torch.Tensor, rows: torch.Tensor, n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A plain transcription of the float64 kernel's auction, for the CPU
    tests, in ``RowPartition.best_bid``'s form: row ``rows[k]`` bids
    ``gaps[k]`` for column ``cols[k]`` (n for none).  Each column's largest
    key by a max (0 for none), then the lowest row among the bids whose key
    reaches it (a max of inverted rows; n for none); the gap decoded from
    the key.  Over n + 1 slots."""
    keys = gap_keys(gaps)
    c = cols.numpy()
    best = np.zeros(n + 1, np.uint64)
    bid = c < n
    np.maximum.at(best, c[bid], keys[bid])
    win = np.full(n + 1, n, np.int64)
    cand = bid & (keys >= best[np.minimum(c, n)])
    np.minimum.at(win, c[cand], rows.numpy()[cand])
    col_best = np.where(best != 0, _key_gaps(best), -np.inf).astype(gaps.numpy().dtype)
    return torch.from_numpy(col_best), torch.from_numpy(win)


def arr_rounds_by_ranks(
    C: torch.Tensor, x: torch.Tensor, y: torch.Tensor, v: torch.Tensor, max_rounds: int,
    min_delta: float, blocks: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """A plain transcription of the kernel's rounds on the CPU, for the
    tests: the block-local copy of v, y and the free rows (every block's is
    the same); the free rows ranked in row order, rank k bidding for block
    k mod ``blocks`` (float32: K4's key state, ``two_min_by_keys``, min1 and
    min2 read back from their keys; float64: ``two_min_plain``); each bid
    into round r's set of ``BUFFERS`` slot buffers (float32
    ``winner_words``, float64 a key then, after a barrier, a row), the bid
    or none stored in the entry of its rank, and counted; after the barrier
    the entries whose bid won applied to the copy, entry k writing the
    outputs; round r's slots cleared in round r + 2, its count at barrier
    r + 2.  The rounds stop at ``max_rounds`` or at a count of 0.  Returns
    (x, y, v, rounds)."""
    from .twomin import two_min_by_keys, two_min_plain

    n = C.shape[0]
    f64 = C.dtype == torch.float64
    mask = 0xFFFFFFFF
    x_out, y_out, v_out = x.clone(), y.clone(), v.clone()
    v_l, y_l, free = v.clone(), y.clone(), (x < 0).clone()
    slot = np.zeros((BUFFERS, n), np.uint64)
    row_slot = np.zeros((BUFFERS, n), np.uint64)
    entries = [[] for _ in range(BUFFERS)]
    counts = [0] * BUFFERS
    rnd, count, free1, free2 = 0, 1, 0, 0
    while rnd < max_rounds and count:
        buf, old = rnd % BUFFERS, (rnd + 1) % BUFFERS
        for e in entries[old][:free2]:
            if e is not None:
                slot[old, e[0]] = row_slot[old, e[0]] = 0
        assert not slot[buf].any() and not row_slot[buf].any() and counts[buf] == 0
        rows = torch.nonzero(free).flatten()
        if f64:
            min1, min2, j1 = two_min_plain(C[rows], v_l)
        else:
            min1, min2, j1 = (m + 0.0 for m in two_min_by_keys(C[rows], v_l))
        gap = min2 - min1
        bid = ((gap > min_delta) & torch.isfinite(min2)).tolist()
        keys = gap_keys(gap) if f64 else _gap_keys32(gap)
        entries[buf] = [None] * len(rows)
        order = [k for blk in range(blocks) for k in range(blk, len(rows), blocks)]
        for k in order:
            if not bid[k]:
                continue
            i, j = int(rows[k]), int(j1[k])
            word = keys[k] if f64 else (keys[k] << np.uint64(32)) | np.uint64(~i & mask)
            slot[buf, j] = max(slot[buf, j], word)
            entries[buf][k] = (j, i)
            counts[buf] += 1
        if f64:  # the second barrier: the lowest row at the largest key
            for k in order:
                j = int(j1[k])
                if bid[k] and keys[k] == slot[buf, j]:
                    row_slot[buf, j] = max(row_slot[buf, j], ~int(rows[k]) & mask)
        counts[old] = 0  # the barrier resets the count of the next round
        count = counts[buf]
        for k, e in enumerate(entries[buf] if count else []):
            if e is None:
                continue
            j, i = e
            w = slot[buf, j]
            if (~int(row_slot[buf, j] if f64 else w) & mask) != i:
                continue
            g = _key_gaps(np.array([w])) if f64 else _key_gaps32(np.array([w >> np.uint64(32)]))
            g = torch.from_numpy(g).to(v.dtype)
            kicked = int(y_l[j])
            if kicked >= 0:
                free[kicked] = True
            free[i] = False
            nv = v_l[j : j + 1] - torch.where(g > 0, g, torch.zeros_like(g))
            v_l[j], y_l[j] = nv[0], i
            if kicked >= 0:
                x_out[kicked] = -1
            x_out[i], y_out[j], v_out[j] = j, i, nv[0]
        free2, free1 = free1, len(rows)
        rnd += 1
    return x_out, y_out, v_out, rnd


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


_OCCUPANCY: Dict[Tuple[int, int, int, int, int], int] = {}


def arr_auction_kernel(
    C: torch.Tensor, x: torch.Tensor, y: torch.Tensor, v: torch.Tensor, max_rounds: int,
    min_delta: float, counts: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors: new (x, y, v); the inputs are not changed."""
    return _arr(C, x, y, v, max_rounds, min_delta, counts)


def _arr(C, x, y, v, max_rounds, min_delta, counts, layout: Optional[str] = None):
    """The kernel in ``arr_layout``'s layout, or in the one given, so that
    the global layout also runs where the resident one fits, to hold them
    against each other.  A layout the card cannot hold raises."""
    if C.device.type != "cuda":
        raise ValueError(f"arr: unsupported device {C.device}")
    _check_state(C, x, y, v, counts, 1, "arr")
    from ._lib import KERNEL_LIBS, launched, ptr, sm_count, stream_ptr

    n, f64, itemsize = C.shape[0], int(C.dtype == torch.float64), C.element_size()
    sms = sm_count(C.device)
    layout = arr_layout(n, itemsize, sms) if layout is None else layout
    if layout not in LAYOUTS:
        raise ValueError(f"arr: unknown layout {layout!r}")
    lib = KERNEL_LIBS["arr"].load()
    with torch.cuda.device(C.device):
        vec = int(not f64 and n % 4 == 0 and C.data_ptr() % 16 == 0)
        smem = arr_smem_bytes(n, itemsize, -(-n // min(n, sms)), layout)
        key = (C.device.index, f64, vec, LAYOUTS.index(layout), smem)
        if key not in _OCCUPANCY:
            _OCCUPANCY[key] = lib.lapgnn_arr_occupancy(f64, vec, LAYOUTS.index(layout), smem)
        g = arr_geometry(n, itemsize, sms, _OCCUPANCY[key], layout)
        x, y, v = x.contiguous(), y.contiguous(), v.contiguous()
        xo, yo, vo = torch.empty_like(x), torch.empty_like(y), torch.empty_like(v)
        work = torch.zeros(lib.lapgnn_arr_work_bytes(n, f64), dtype=torch.uint8, device=C.device)
        state = torch.empty(g.blocks * arr_state_stride(n, itemsize) if layout == "global" else 0,
                            dtype=torch.uint8, device=C.device)
        launch = lib.lapgnn_arr_f64 if f64 else lib.lapgnn_arr
        extra = () if f64 else (vec,)
        rc = launch(ptr(C), ptr(x), ptr(y), ptr(v), ptr(xo), ptr(yo), ptr(vo), ptr(work),
                    ptr(state), ptr(counts), n, max_rounds, min_delta, *extra,
                    LAYOUTS.index(layout), g.blocks, -(-n // g.blocks), stream_ptr(C.device))
    launched(rc, f"arr kernel ({layout})", "arr_auction")
    return xo, yo, vo


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
