"""K4 per-row two-minimum of C - v: CUDA kernel and plain version.

Replaces ``lapgnn_tpu/ops/pallas/twomin.py:pallas_two_min`` (:40).  The
kernel lives in ``csrc/twomin.cu``; it is the bid of every Jacobi-ARR round
of the device solver (``solver/seeded.jacobi_arr``).

Bound on this card: device-memory bytes.  One call reads C and v once and
writes three (n,) vectors, ``B*n*m*4 + B*m*4 + 3*B*n*4`` bytes: about 5.0 us
at n = m = 2048 and 80 us at 8192 at an H100 SXM's 3.35 TB/s.  In practice
the 16 MB of the solver's size sit in L2 between ARR rounds and the read
lasts a few microseconds, much of it launch, ramp and tail, while the
compares cost about ten integer-pipe operations a column.  Design: one
warp per row (coalesced 16-byte row reads), four loads requested ahead of the
compares, and a branch-free compare state per lane, integer order keys on
which NaN is smallest and -0.0 equals +0.0, merged across lanes by shuffles;
``C - v`` never reaches memory.  A matrix beyond L2 takes the float compare
state, faster when the kernel streams from device memory.
``two_min_geometry`` is the launch geometry the wrapper hands to the kernel.

The plain version is the three-pass form the JAX ``jacobi_arr`` computes
(seeded.py:199-202): argmin, a gather at the argmin, and the minimum with
that column masked to +inf.  The kernel equals it bit for bit, the argmin's
first-index and NaN rules included.  float64 (the float64 solves of the
device solver) takes the float compare state over doubles with 8-byte loads,
a form the Pallas kernel, float32 only, does not have.  A CUDA tensor
launches the kernel (or raises); only a CPU tensor takes the plain version.
The wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

__all__ = [
    "TwoMinGeometry",
    "order_key",
    "two_min",
    "two_min_by_keys",
    "two_min_geometry",
    "two_min_kernel",
    "two_min_plain",
]

# Launch geometry of ``csrc/twomin.cu`` (its constants, mirrored).
WARPS_PER_BLOCK = 8  # one warp a row
THREADS = 32 * WARPS_PER_BLOCK
L2_BYTES = 50 * 2**20  # an H100's L2


@dataclass(frozen=True)
class TwoMinGeometry:
    """How the kernel is launched: one warp a row, ``rows_per_block`` rows a
    block of ``threads`` threads, ``blocks`` blocks per matrix, no shared
    memory.  ``vector`` selects 16-byte loads, ``unroll`` is the number of
    loads requested ahead of the compares, ``state`` the compare state of a lane
    (``"keys"``: branch-free integer order keys; ``"floats"``: float compares
    with a branch per column)."""

    vector: bool
    unroll: int
    state: str
    warps_per_row: int
    rows_per_block: int
    threads: int
    blocks: int
    smem_bytes: int


def two_min_geometry(
    n: int,
    m: int,
    aligned: bool,
    batch: int = 1,
    state: str | None = None,
    unroll: int | None = None,
    itemsize: int = 4,
) -> TwoMinGeometry:
    """The launch an (n, m) matrix takes.  ``aligned``: the bases of C and v
    are 16-byte aligned (16-byte loads also need m % 4 == 0).  A float32
    batch that fits in L2 takes the integer-key state, the faster of the two
    there; a larger one streams from device memory, where the float state is
    faster, with four loads ahead up to four times L2 (n = 4096) and one
    beyond (n = 8192), as measured on an H100.  float64 (``itemsize`` 8)
    takes the float state with 8-byte loads.  ``state`` and ``unroll`` force
    a variant, to time one beside another."""
    if n < 1 or m < 1:
        raise ValueError(f"two_min: empty matrix ({n}, {m})")
    if itemsize not in (4, 8):
        raise ValueError(f"two_min: itemsize {itemsize}")
    nbytes = itemsize * batch * n * m
    if state is None:
        state = "keys" if itemsize == 4 and nbytes <= L2_BYTES else "floats"
    if state not in ("keys", "floats"):
        raise ValueError(f"two_min: unknown state {state!r}")
    if itemsize == 8 and state != "floats":
        raise ValueError("two_min: float64 takes the float state only")
    if unroll is None:
        unroll = 4 if nbytes <= 4 * L2_BYTES else 1
    if unroll not in (1, 4):
        raise ValueError(f"two_min: unroll {unroll}")
    return TwoMinGeometry(
        vector=itemsize == 4 and bool(aligned) and m % 4 == 0, unroll=unroll, state=state,
        warps_per_row=1, rows_per_block=WARPS_PER_BLOCK, threads=THREADS,
        blocks=-(-n // WARPS_PER_BLOCK), smem_bytes=0,
    )


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


def order_key(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order key of a reduced cost (uint32 held in int64): NaN
    below everything, -0.0 equal to +0.0, else the order of the floats."""
    u = (x + 0.0).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where((u & 0x80000000) != 0, 0xFFFFFFFF - u, u | 0x80000000) + 1
    return torch.where(torch.isnan(x), torch.zeros_like(key), key)


def two_min_by_keys(
    C: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A plain transcription of the kernel's integer-key state, for the CPU
    tests: the two smallest (key, column) pairs of each row as 64-bit words,
    min1 and min2 the elements at their columns (+inf where a row has one
    column)."""
    red = C - v[..., None, :]
    m = red.shape[-1]
    # int64 holds key * 2^31 + column without overflow: keys are below 2^32
    packed = order_key(red) * (1 << 31) + torch.arange(m, device=red.device)
    two = packed.sort(-1).values[..., :2] % (1 << 31)
    min1 = red.gather(-1, two[..., :1])[..., 0]
    if m == 1:
        min2 = torch.full_like(min1, float("inf"))
    else:
        min2 = red.gather(-1, two[..., 1:2])[..., 0]
    return min1, min2, two[..., 0].to(torch.int32)


def _check(C: torch.Tensor, v: torch.Tensor) -> None:
    if C.dtype not in (torch.float32, torch.float64) or v.dtype != C.dtype:
        raise TypeError(
            f"two_min: C and v must both be float32 or both float64, got {C.dtype}, {v.dtype}")
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


def two_min_kernel(
    C: torch.Tensor, v: torch.Tensor, **force
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors.  ``force`` reaches ``two_min_geometry``
    (``state``, ``unroll``)."""
    if C.device.type != "cuda":
        raise ValueError(f"two_min: unsupported device {C.device}")
    _check(C, v)
    from ._lib import KERNEL_LIBS, check, ptr, stream_ptr

    Cb = C if C.ndim == 3 else C[None]
    vb = v if v.ndim == 2 else v[None]
    B, n, m = Cb.shape
    if B > 65535:
        raise ValueError(f"two_min: batch {B} exceeds the kernel's grid limit 65535")
    g = two_min_geometry(
        n, m, aligned=Cb.data_ptr() % 16 == 0 and vb.data_ptr() % 16 == 0,
        batch=B, itemsize=C.element_size(), **force,
    )
    lib = KERNEL_LIBS["twomin"].load()
    min1 = torch.empty((B, n), dtype=C.dtype, device=C.device)
    min2 = torch.empty((B, n), dtype=C.dtype, device=C.device)
    arg = torch.empty((B, n), dtype=torch.int32, device=C.device)
    with torch.cuda.device(C.device):
        if C.dtype == torch.float64:
            rc = lib.lapgnn_two_min_f64(
                ptr(Cb), ptr(vb), ptr(min1), ptr(min2), ptr(arg), B, n, m, g.unroll,
                stream_ptr(C.device),
            )
        else:
            rc = lib.lapgnn_two_min(
                ptr(Cb), ptr(vb), ptr(min1), ptr(min2), ptr(arg), B, n, m,
                int(g.vector), g.unroll, int(g.state == "floats"), stream_ptr(C.device),
            )
    check(rc, "two_min kernel")
    two_min.launches += 1
    if C.ndim == 2:
        return min1[0], min2[0], arg[0]
    return min1, min2, arg


def two_min(
    C: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: (min1, min2, argmin1) of the rows of C - v, for (n, m), (m,) or
    (B, n, m), (B, m) float32 or float64; argmin1 is int32.  Bit-equal to
    ``two_min_plain``.  A CPU tensor takes the plain version; any other
    launches the kernel, which raises for a dtype other than float32 and
    float64."""
    if C.device.type == "cpu":
        return two_min_plain(C, v)
    return two_min_kernel(C, v)


two_min.launches = 0
