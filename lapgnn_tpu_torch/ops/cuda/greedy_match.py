"""S3 greedy maximal matching on the tight edges: CUDA kernel and plain version.

Replaces ``lapgnn_tpu/solver/seeded.py:greedy_tight_matching`` (:99), a
``lax.while_loop`` of proposal rounds that XLA runs on the device (no Pallas
kernel).  The kernel (``csrc/greedy_match.cu``) runs every round in one
cooperative launch until a round matches nothing: every free row proposes
its lowest available tight column in round 0 and its lowest-hash one later
(``_hash_scores``, seeded.py:71, in wrapping uint32 arithmetic), the lowest
column on a tie, as one 64-bit (score, column) minimum a warp; each column
takes its lowest proposing row by an atomicMin.  ``greedy_match_blocks``
sizes its grid.

Bound on this card: device-memory bytes, the bool matrix read once a round:
``rounds * n * n`` bytes at 3.35 TB/s (only the free rows are read); a
round is two grid syncs and the free rows' scans.

The plain version is the eager loop
``solver.seeded._greedy_tight_matching_eager``; the kernel equals it (x, y
and the rounds).  A CUDA tensor launches the kernel (or raises); only a CPU
tensor takes the plain version.  The wrapper counts its kernel launches in
``.launches``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = [
    "greedy_match",
    "greedy_match_blocks",
    "greedy_match_kernel",
    "greedy_match_plain",
    "proposals_by_keys",
]

WARPS_PER_BLOCK = 8  # csrc/greedy_match.cu: a warp a row, 256 threads
MAX_SMEM = 232_448  # the free columns, a byte each, in a block's shared memory


def greedy_match_blocks(n: int, sms: int, occupancy: int) -> int:
    """The cooperative grid: ``coop_blocks``, no more blocks than rows of
    eight warps."""
    from ._lib import coop_blocks

    if n > MAX_SMEM:
        raise ValueError(f"greedy_match: n = {n} exceeds the {MAX_SMEM} columns a block holds")
    return coop_blocks(occupancy, sms, -(-n // WARPS_PER_BLOCK))


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
    from ._lib import KERNEL_LIBS, check, ptr, sm_count, stream_ptr

    n = tight.shape[0]
    lib = KERNEL_LIBS["greedy_match"].load()
    with torch.cuda.device(tight.device):
        key = (tight.device.index, n)
        if key not in _OCCUPANCY:
            _OCCUPANCY[key] = lib.lapgnn_greedy_match_occupancy(n)
        blocks = greedy_match_blocks(n, sm_count(tight.device), _OCCUPANCY[key])
        x = torch.full((n,), -1, dtype=torch.int64, device=tight.device)
        y = torch.full((n,), -1, dtype=torch.int64, device=tight.device)
        work = torch.empty(lib.lapgnn_greedy_match_work_bytes(n), dtype=torch.uint8,
                           device=tight.device)
        rc = lib.lapgnn_greedy_match(ptr(tight), ptr(x), ptr(y), ptr(work), ptr(counts), n,
                                     blocks, stream_ptr(tight.device))
    check(rc, "greedy_match kernel")
    greedy_match.launches += 1
    return x, y


def greedy_match(tight: torch.Tensor, counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """S3: a maximal matching (x, y) on the True entries of a square bool
    matrix by parallel proposal rounds; adds the rounds to ``counts``.  A
    CPU tensor takes the plain version; any other launches the kernel."""
    if tight.device.type == "cpu":
        return greedy_match_plain(tight, counts)
    return greedy_match_kernel(tight, counts)


greedy_match.launches = 0
