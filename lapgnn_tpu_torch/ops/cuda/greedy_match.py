"""S3 greedy maximal matching on the tight edges: CUDA kernel and plain version.

Replaces ``lapgnn_tpu/solver/seeded.py:greedy_tight_matching`` (:99), a
``lax.while_loop`` of proposal rounds that XLA runs on the device (no Pallas
kernel).  The kernel (``csrc/greedy_match.cu``) runs every round in one
cooperative launch until a round matches nothing, with one grid barrier a
round that carries the stop test: each block keeps a bit a free row and a
bit a free column in its shared memory, ranks the free rows and scans its
share of them, the row's bytes 16 a load against the free columns' bits;
every free row proposes its lowest available tight column in round 0 and
its lowest-hash one later (``_hash_scores``, seeded.py:71, in wrapping
uint32 arithmetic), the lowest column on a tie, as one 64-bit (score,
column) minimum; each column takes its lowest proposing row by an atomicMax
of the inverted row, each proposal also stored in the entry of its row's
rank, and every block applies the round's winning entries to its bits
(``greedy_rounds_by_words`` transcribes the rounds).
``greedy_match_geometry`` is the launch; the bits fit a block's shared
memory up to n = 828,288 on 132 SMs, beyond any matrix the card holds.

Bound on this card: device-memory bytes, the bool matrix's free rows read
once a round: ``sum of free rows * n`` bytes at 3.35 TB/s; a round is one
grid barrier and the free rows' scans.

The plain version is the eager loop
``solver.seeded._greedy_tight_matching_eager``; the kernel equals it (x, y
and the rounds).  A CUDA tensor launches the kernel (or raises); only a CPU
tensor takes the plain version.  The wrapper counts its kernel launches in
the tracer's ``launch.greedy_match``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .augment import MAX_SMEM, THREADS, CoopGeometry

__all__ = [
    "greedy_match",
    "greedy_match_geometry",
    "greedy_match_kernel",
    "greedy_match_plain",
    "greedy_match_smem_bytes",
    "greedy_rounds_by_words",
    "proposals_by_keys",
]

STATIC_SMEM = 256  # at least the kernel's static shared memory (lapgnn_greedy_match_static_smem)
BUFFERS = 3  # csrc/free_rows.cuh's kRoundBuffers


def _align4(words: int) -> int:
    return (words + 3) & ~3


def greedy_match_smem_bytes(n: int, own_cap: int) -> int:
    """A block's dynamic shared memory (``smem_bytes``): a bit a row, a bit
    a column and a zero word past them, the block's rows of a round."""
    words = -(-n // 32)
    return 4 * (_align4(words) + _align4(words + 1) + _align4(own_cap))


def greedy_match_geometry(n: int, sms: int, occupancy: int) -> CoopGeometry:
    """The cooperative launch: ``coop_blocks`` blocks of 256 threads, one a
    SM, no more blocks than rows, and the bits' shared memory; an n whose
    bits do not fit raises."""
    from ._lib import coop_blocks

    blocks = min(n, sms)
    smem = greedy_match_smem_bytes(n, -(-n // blocks))
    if smem + STATIC_SMEM > MAX_SMEM:
        raise ValueError(f"greedy_match: n = {n} needs {smem} B of shared memory a block, "
                         f"above {MAX_SMEM - STATIC_SMEM}")
    blocks = coop_blocks(occupancy, sms, n, 1)
    return CoopGeometry(blocks=blocks, threads=THREADS, tile=0,
                        smem_bytes=greedy_match_smem_bytes(n, -(-n // blocks)))


def proposals_by_keys(avail: torch.Tensor, rnd: int) -> torch.Tensor:
    """A plain transcription of the kernel's proposals, for the CPU tests:
    each row's least 64-bit word (score << 32 | column) over its available
    columns, the score the column in round 0 and ``hash_score`` (uint32
    arithmetic, here in int64 with masks) later; the proposed column, -1
    where none is available.  (n, n) bool -> (n,) int64."""
    n = avail.shape[0]
    i = torch.arange(n, dtype=torch.int64)[:, None]
    j = torch.arange(n, dtype=torch.int64)[None, :]
    if rnd == 0:
        score = j.expand(n, n)
    else:
        u32 = 0xFFFFFFFF
        h = (((i * 0x9E3779B1) & u32) + ((j * 0x85EBCA77) & u32) + ((rnd * 0xC2B2AE3D) & u32)) & u32
        h = h ^ (h >> 15)
        h = (h * 0x27D4EB2F) & u32
        h = h ^ (h >> 13)
        score = torch.clamp_max(h & 0x7FFFFFFF, 0x7FFFFFFE)
    word = torch.where(avail, (score << 32) | j, torch.iinfo(torch.int64).max)
    best = word.amin(1)
    return torch.where(avail.any(1), best & 0xFFFFFFFF, -1)


def _nonzero4(u: int) -> int:
    """``nonzero4``: four little-endian bytes as four bits."""
    u |= u >> 4
    u |= u >> 2
    u |= u >> 1
    return (((u & 0x01010101) * 0x01020408) & 0xFFFFFFFF) >> 24


def _bits16(words: np.ndarray, c: int) -> int:
    """``bits16``: bits c .. c + 15 of a bit array with a zero word past its
    end."""
    pair = int(words[c >> 5]) | (int(words[(c >> 5) + 1]) << 32)
    return (pair >> (c & 31)) & 0xFFFF


def _propose_by_words(row: np.ndarray, scores, free_cols: np.ndarray, rnd: int,
                      addr: int) -> int:
    """``propose`` over one row's bytes (uint8) that start at an address of
    ``addr`` mod 16: the unaligned head and the tail a byte at a time, the
    body 16 bytes a word folded into 16 bits against the free columns'
    bits; the least (score, column) word, or -1.  ``scores``: the row's
    hash scores (rounds after 0)."""
    n = len(row)
    best = -1

    def take(j: int) -> None:
        nonlocal best
        score = j if rnd == 0 else int(scores[j])
        key = (score << 32) | j
        best = key if best < 0 else min(best, key)

    head = min(n, (16 - addr % 16) % 16)
    body = (n - head) >> 4
    tail = head + 16 * body
    for j in [*range(head), *range(tail, n)]:
        if row[j] and (free_cols[j >> 5] >> (j & 31)) & 1:
            take(j)
    for q in range(body):
        c0 = head + 16 * q
        w = row[c0 : c0 + 16].tobytes()
        bits = 0
        for k in range(4):
            bits |= _nonzero4(int.from_bytes(w[4 * k : 4 * k + 4], "little")) << (4 * k)
        avail = bits & _bits16(free_cols, c0)
        while avail:
            take(c0 + (avail & -avail).bit_length() - 1)
            avail = 0 if rnd == 0 else avail & (avail - 1)
    return best


def greedy_rounds_by_words(
    tight: torch.Tensor, blocks: int = 3, addr: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """A plain transcription of the kernel's rounds on the CPU, for the
    tests: a bit a free row and a bit a free column (every block's are the
    same); the free rows ranked in row order, rank k proposing for block
    k mod ``blocks`` (``_propose_by_words``, the matrix at an address of
    ``addr`` mod 16); each proposal an atomicMax of the inverted row on
    round r's slot, of ``BUFFERS``, stored (or none) in the entry of its
    rank and counted; after the barrier the entries whose proposal won
    applied to the bits, entry k writing x and y; round r's slots cleared
    in round r + 2.  The rounds stop at a count of 0.  Returns (x, y,
    rounds)."""
    from ...solver.seeded import _hash_scores

    n = tight.shape[0]
    t = tight.numpy().astype(np.uint8)
    words = -(-n // 32)
    full = np.full(words + 1, 0xFFFFFFFF, np.uint64)
    full[words - 1] = (1 << (n % 32)) - 1 if n % 32 else 0xFFFFFFFF
    full[words] = 0
    free_rows, free_cols = full[:words].copy(), full.copy()
    x = torch.full((n,), -1, dtype=torch.int64)
    y = torch.full((n,), -1, dtype=torch.int64)
    slot = np.zeros((BUFFERS, n), np.uint64)
    entries = [[] for _ in range(BUFFERS)]
    counts = [0] * BUFFERS
    rnd, free1, free2 = 0, 0, 0
    while True:
        buf, old = rnd % BUFFERS, (rnd + 1) % BUFFERS
        for e in entries[old][:free2]:
            if e is not None:
                slot[old, e[0]] = 0
        assert not slot[buf].any() and counts[buf] == 0
        rows = [32 * q + b for q in range(words) for b in range(32) if (int(free_rows[q]) >> b) & 1]
        entries[buf] = [None] * len(rows)
        scores = _hash_scores(n, rnd).numpy() if rnd else None
        for k in [k for blk in range(blocks) for k in range(blk, len(rows), blocks)]:
            i = rows[k]
            best = _propose_by_words(t[i], scores[i] if rnd else None, free_cols, rnd,
                                     addr + i * n)
            if best >= 0:
                j = best & 0xFFFFFFFF
                slot[buf, j] = max(int(slot[buf, j]), ~i & 0xFFFFFFFF)
                entries[buf][k] = (j, i)
                counts[buf] += 1
        counts[old] = 0
        count = counts[buf]
        for e in entries[buf] if count else []:
            if e is None or (~int(slot[buf, e[0]]) & 0xFFFFFFFF) != e[1]:
                continue
            j, i = e
            free_rows[i >> 5] = int(free_rows[i >> 5]) & ~(1 << (i & 31))
            free_cols[j >> 5] = int(free_cols[j >> 5]) & ~(1 << (j & 31))
            x[i], y[j] = j, i
        free2, free1 = free1, len(rows)
        rnd += 1
        if count == 0:
            return x, y, rnd


def greedy_match_plain(tight: torch.Tensor, counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eager ``greedy_tight_matching`` of a square bool matrix; adds its
    rounds to ``counts`` (1 int64 on its device)."""
    from ...solver.jv import SolveStats
    from ...solver.seeded import _greedy_tight_matching_eager

    stats = SolveStats()
    x, y = _greedy_tight_matching_eager(tight, stats)
    counts += torch.tensor([stats.greedy_rounds], dtype=counts.dtype, device=counts.device)
    return x, y


_OCCUPANCY: Dict[Tuple[int, int], int] = {}


def greedy_match_kernel(tight: torch.Tensor, counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on a CUDA bool matrix: (x, y), each (n,) int64."""
    if tight.device.type != "cuda":
        raise ValueError(f"greedy_match: unsupported device {tight.device}")
    if tight.dtype != torch.bool:
        raise TypeError(f"greedy_match: tight must be bool, got {tight.dtype}")
    if tight.ndim != 2 or tight.shape[0] != tight.shape[1] or tight.shape[0] < 1:
        raise ValueError(f"greedy_match: takes a square (n, n) matrix, got {tuple(tight.shape)}")
    if not tight.is_contiguous():
        raise ValueError("greedy_match: tight must be contiguous")
    if counts.dtype != torch.int64 or counts.numel() < 1 or counts.device != tight.device:
        raise ValueError("greedy_match: counts must be int64 on tight's device")
    from ._lib import KERNEL_LIBS, launched, ptr, sm_count, stream_ptr

    n = tight.shape[0]
    sms = sm_count(tight.device)
    lib = KERNEL_LIBS["greedy_match"].load()
    with torch.cuda.device(tight.device):
        smem = greedy_match_smem_bytes(n, -(-n // min(n, sms)))
        key = (tight.device.index, smem)
        if key not in _OCCUPANCY:
            _OCCUPANCY[key] = lib.lapgnn_greedy_match_occupancy(smem)
        g = greedy_match_geometry(n, sms, _OCCUPANCY[key])
        x = torch.empty((n,), dtype=torch.int64, device=tight.device)
        y = torch.empty((n,), dtype=torch.int64, device=tight.device)
        work = torch.zeros(lib.lapgnn_greedy_match_work_bytes(n), dtype=torch.uint8,
                           device=tight.device)
        rc = lib.lapgnn_greedy_match(ptr(tight), ptr(x), ptr(y), ptr(work), ptr(counts), n,
                                     g.blocks, -(-n // g.blocks), stream_ptr(tight.device))
    launched(rc, "greedy_match kernel", "greedy_match")
    return x, y


def greedy_match(tight: torch.Tensor, counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """S3: a maximal matching (x, y) on the True entries of a square bool
    matrix by parallel proposal rounds; adds the rounds to ``counts``.  A
    CPU tensor takes the plain version; any other launches the kernel."""
    if tight.device.type == "cpu":
        return greedy_match_plain(tight, counts)
    return greedy_match_kernel(tight, counts)
