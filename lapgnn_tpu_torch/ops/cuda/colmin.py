"""K1 column minimum and K2 fused min-trick: CUDA kernels and plain versions.

Replace ``lapgnn_tpu/ops/pallas/colmin.py``: ``pallas_col_min`` (:75) and
``pallas_min_trick`` (:94).  Both kernels live in ``csrc/colmin.cu``.

Bound on this card: device-memory bytes.  One call reads C once,
``B*n*m*4`` bytes, about 5.0 us at n = m = 2048 and 80 us at 8192 at an
H100 SXM's 3.35 TB/s.  Design: one thread per column (coalesced row reads),
the rows cut into chunks across ``grid.y`` so every SM has blocks, partial
minima reduced by a second small launch.  See the source for details.

A CUDA tensor launches the kernel (or raises); only a CPU tensor takes the
plain version.  Each wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["col_min", "col_min_plain", "min_trick", "min_trick_plain"]

_THREADS = 256
# Blocks to aim for: 8 resident blocks of 256 threads on each of 132 SMs.
_TARGET_BLOCKS = 132 * 8


def col_min_plain(C: torch.Tensor) -> torch.Tensor:
    """(…, n, m) -> (…, m) column minimum."""
    return C.amin(-2)


def min_trick_plain(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(…, n, m), (…, n) -> (…, m): v_j = min_i (C_ij - u_i)."""
    return (C - u[..., :, None]).amin(-2)


def _as_batch(C: torch.Tensor, u: Optional[torch.Tensor], what: str):
    if C.dtype != torch.float32:
        raise TypeError(f"{what}: C must be float32, got {C.dtype}")
    if C.ndim not in (2, 3):
        raise ValueError(f"{what}: C must be (n, m) or (B, n, m), got {tuple(C.shape)}")
    if not C.is_contiguous():
        raise ValueError(f"{what}: C must be contiguous")
    Cb = C if C.ndim == 3 else C[None]
    B, n, m = Cb.shape
    if n < 1 or m < 1:
        raise ValueError(f"{what}: empty matrix {tuple(C.shape)}")
    ub = None
    if u is not None:
        if u.dtype != torch.float32 or u.device != C.device:
            raise TypeError(f"{what}: u must be float32 on {C.device}")
        if tuple(u.shape) != tuple(C.shape[:-1]):
            raise ValueError(
                f"{what}: u has shape {tuple(u.shape)}, expected {tuple(C.shape[:-1])}"
            )
        if not u.is_contiguous():
            raise ValueError(f"{what}: u must be contiguous")
        ub = u if u.ndim == 2 else u[None]
    return Cb, ub, (B, n, m)


def _chunking(B: int, n: int, m: int) -> Tuple[int, int]:
    col_blocks = -(-m // _THREADS)
    chunks = max(1, min(n, 65535, -(-_TARGET_BLOCKS // (col_blocks * B))))
    rows_per_chunk = -(-n // chunks)
    return -(-n // rows_per_chunk), rows_per_chunk


def _launch(Cb: torch.Tensor, ub: Optional[torch.Tensor], shape) -> torch.Tensor:
    from ._lib import KERNEL_LIBS, check, ptr, stream_ptr

    B, n, m = shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid limit 65535")
    chunks, rows_per_chunk = _chunking(B, n, m)
    lib = KERNEL_LIBS["colmin"].load()
    part = torch.empty((B, chunks, m), dtype=torch.float32, device=Cb.device)
    out = torch.empty((B, m), dtype=torch.float32, device=Cb.device)
    with torch.cuda.device(Cb.device):
        rc = lib.lapgnn_colmin(
            ptr(Cb), None if ub is None else ptr(ub), ptr(part), ptr(out),
            B, n, m, chunks, rows_per_chunk, stream_ptr(Cb.device),
        )
    check(rc, "colmin kernel")
    return out


def col_min(C: torch.Tensor) -> torch.Tensor:
    """K1: (n, m) -> (m,) or (B, n, m) -> (B, m) column minimum.

    Replaces ``ops/pallas/colmin.py:pallas_col_min``; bit-equal to
    ``col_min_plain``."""
    if C.device.type == "cpu":
        return col_min_plain(C)
    if C.device.type != "cuda":
        raise ValueError(f"col_min: unsupported device {C.device}")
    Cb, _, shape = _as_batch(C, None, "col_min")
    out = _launch(Cb, None, shape)
    col_min.launches += 1
    return out if C.ndim == 3 else out[0]


def min_trick(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """K2: v_j = min_i (C_ij - u_i) for (n, m), (n,) or (B, n, m), (B, n).

    Replaces ``ops/pallas/colmin.py:pallas_min_trick``; C - u is never
    materialised.  Bit-equal to ``min_trick_plain``."""
    if C.device.type == "cpu":
        return min_trick_plain(C, u)
    if C.device.type != "cuda":
        raise ValueError(f"min_trick: unsupported device {C.device}")
    Cb, ub, shape = _as_batch(C, u, "min_trick")
    out = _launch(Cb, ub, shape)
    min_trick.launches += 1
    return out if C.ndim == 3 else out[0]


col_min.launches = 0
min_trick.launches = 0
