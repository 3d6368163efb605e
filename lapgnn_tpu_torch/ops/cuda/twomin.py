"""K4 per-row two-minimum of C - v: CUDA kernel and plain version.

Replaces ``lapgnn_tpu/ops/pallas/twomin.py:pallas_two_min`` (:40).  The
kernel lives in ``csrc/twomin.cu``; it is the bid of every Jacobi-ARR round
of the device solver (``solver/seeded.jacobi_arr``).

Bound on this card: device-memory bytes.  One call reads C and v once and
writes three (n,) vectors, ``B*n*m*4 + B*m*4 + 3*B*n*4`` bytes: about 5.0 us
at n = m = 2048 and 80 us at 8192 at an H100 SXM's 3.35 TB/s.  Design: one
warp per row (coalesced 16-byte row reads), each lane keeps (min1, argmin1,
min2) and the lanes merge by warp shuffles; ``C - v`` never reaches memory.
See the source for details.

The plain version is the three-pass form the JAX ``jacobi_arr`` computes
(seeded.py:199-202): argmin, a gather at the argmin, and the minimum with
that column masked to +inf.  The kernel equals it bit for bit, the argmin's
first-index and NaN rules included.  A CUDA tensor launches the kernel (or
raises); only a CPU tensor takes the plain version.  The wrapper counts its
kernel launches in ``.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["two_min", "two_min_plain"]

_WARPS_PER_BLOCK = 8


def two_min_plain(
    C: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(…, n, m), (…, m) -> (min1, min2, argmin1 int32), each (…, n), of
    the rows of C - v."""
    red = C - v[..., None, :]
    j1 = red.argmin(-1, keepdim=True)
    min1 = red.gather(-1, j1)[..., 0]
    min2 = red.scatter(-1, j1, float("inf")).amin(-1)
    return min1, min2, j1[..., 0].to(torch.int32)


def _check(C: torch.Tensor, v: torch.Tensor) -> None:
    if C.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"two_min: C and v must be float32, got {C.dtype}, {v.dtype}")
    if v.device != C.device:
        raise ValueError(f"two_min: v is on {v.device}, C on {C.device}")
    if C.ndim not in (2, 3) or v.ndim != C.ndim - 1:
        raise ValueError(
            f"two_min: takes (n, m), (m,) or (B, n, m), (B, m), got "
            f"{tuple(C.shape)}, {tuple(v.shape)}"
        )
    if tuple(v.shape) != tuple(C.shape[:-2]) + (C.shape[-1],):
        raise ValueError(f"two_min: v has shape {tuple(v.shape)} for C {tuple(C.shape)}")
    if not (C.is_contiguous() and v.is_contiguous()):
        raise ValueError("two_min: C and v must be contiguous")
    if C.shape[-2] < 1 or C.shape[-1] < 1:
        raise ValueError(f"two_min: empty matrix {tuple(C.shape)}")


def two_min(
    C: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: (min1, min2, argmin1) of the rows of C - v, for (n, m), (m,) or
    (B, n, m), (B, m) float32; argmin1 is int32.  Bit-equal to
    ``two_min_plain``."""
    if C.device.type == "cpu":
        return two_min_plain(C, v)
    if C.device.type != "cuda":
        raise ValueError(f"two_min: unsupported device {C.device}")
    _check(C, v)
    from ._lib import KERNEL_LIBS, check, ptr, stream_ptr

    Cb = C if C.ndim == 3 else C[None]
    vb = v if v.ndim == 2 else v[None]
    B, n, m = Cb.shape
    if B > 65535:
        raise ValueError(f"two_min: batch {B} exceeds the kernel's grid limit 65535")
    vec4 = m % 4 == 0 and Cb.data_ptr() % 16 == 0 and vb.data_ptr() % 16 == 0
    lib = KERNEL_LIBS["twomin"].load()
    min1 = torch.empty((B, n), dtype=torch.float32, device=C.device)
    min2 = torch.empty((B, n), dtype=torch.float32, device=C.device)
    arg = torch.empty((B, n), dtype=torch.int32, device=C.device)
    with torch.cuda.device(C.device):
        rc = lib.lapgnn_two_min(
            ptr(Cb), ptr(vb), ptr(min1), ptr(min2), ptr(arg), B, n, m, int(vec4),
            stream_ptr(C.device),
        )
    check(rc, "two_min kernel")
    two_min.launches += 1
    if C.ndim == 2:
        return min1[0], min2[0], arg[0]
    return min1, min2, arg


two_min.launches = 0
