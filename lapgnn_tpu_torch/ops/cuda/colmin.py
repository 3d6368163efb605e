"""K1 column minimum and K2 fused min-trick: CUDA kernels and plain versions.

Replace ``lapgnn_tpu/ops/pallas/colmin.py``: ``pallas_col_min`` (:75) and
``pallas_min_trick`` (:94).  Both kernels live in ``csrc/colmin.cu``.

Bound on this card: device-memory bytes.  One call reads C once,
``B*n*m*4`` bytes, about 5.0 us at n = m = 2048 and 80 us at 8192 at an
H100 SXM's 3.35 TB/s.  At 2048 that bound is out of reach of any single
pass: a launch, the ramp until every SM has loads in flight and the tail are
most of the read, the framework's own ``torch.amin`` takes longer, and
keeping more bytes in flight bought a microsecond at most (measured on an
H100; PERF.md).  So the design removes what is not the read: the second
launch, the scratch and its allocation.  Default path (``"cluster"``):
one launch and no scratch.  A tile of 128 columns belongs to one thread
block cluster whose blocks split the rows; each warp strides over its
block's rows with 16-byte loads and several rows requested ahead of the
compares; warps merge through shared memory, blocks through distributed
shared memory, rank 0 writes.  ``"two_launch"``: one thread a column, row
chunks across the grid, a scratch of partial minima and a second small
launch; it serves tall, narrow matrices, where clusters cannot fill the card.
``col_min_geometry`` picks the path and is what the wrapper hands to the
kernel; ``col_min_by_tiles`` transcribes the kernel's merge tree in torch.

Agreement: bit-equal to the plain versions, NaN propagated at every merge
level, except for the sign of a zero: where a column's minimum is zero and
the column holds both -0.0 and +0.0, the kernel keeps the zero its fixed
order meets first and ``amin`` the one its own order meets (equal values,
possibly another sign bit).  A CUDA tensor launches the kernel (or raises);
only a CPU tensor takes the plain version.  Each wrapper counts its kernel
launches in ``.launches``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

__all__ = [
    "ColMinGeometry",
    "col_min",
    "col_min_by_tiles",
    "col_min_geometry",
    "col_min_kernel",
    "col_min_plain",
    "min_trick",
    "min_trick_plain",
]

# Launch geometry of ``csrc/colmin.cu`` (its constants, mirrored).
TILE = 128  # columns a cluster owns: 32 lanes x 4
WARPS = 8  # a block; 16 were measured no faster (K1) or slower (K2)
MAX_CLUSTER = 8  # the portable limit; 16 was measured no faster
SMS = 132  # an H100's streaming multiprocessors
# The cluster is as large as this many blocks allow: two an SM, so that
# every cluster is resident at once.  Measured on an H100, 512 blocks at
# n = 8192 ran K2 10% slower than 256: its 62 resident clusters of eight left
# two clusters to a second wave.
MAX_BLOCKS = 2 * SMS
# Rows a warp of the cluster path walks from which, with at most a block an
# SM, the read is bound by its latency: such a matrix takes two_launch.
LONG_STRIPE = 512
L2_BYTES = 50 * 2**20  # an H100's L2
TWO_LAUNCH_THREADS = 256  # one thread a column
# two_launch aims for eight resident blocks of 256 threads an SM.
TWO_LAUNCH_TARGET_BLOCKS = 8 * SMS


@dataclass(frozen=True)
class ColMinGeometry:
    """How the kernel is launched.  ``path`` ``"cluster"``: ``cluster``
    blocks of ``warps`` warps own a tile of ``tile`` columns and split the
    rows, ``rows_per_block`` each (a multiple of ``warps``; blocks beyond the
    last row read nothing), ``ahead`` rows requested before the compares,
    ``vector`` for 16-byte loads.  ``"two_launch"``: ``tile`` threads a
    block, one a column, ``row_blocks`` chunks of ``rows_per_block`` rows
    and a second launch over the partial minima.  ``row_blocks`` is the
    number of blocks that share a column tile (the cluster size on the
    cluster path), ``grid`` the launch grid."""

    path: str
    vector: bool
    tile: int
    cluster: int
    row_blocks: int
    rows_per_block: int
    warps: int
    ahead: int
    grid: Tuple[int, int, int]
    smem_bytes: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def col_min_geometry(
    n: int,
    m: int,
    aligned: bool,
    batch: int = 1,
    path: str | None = None,
    cluster: int | None = None,
    ahead: int | None = None,
) -> ColMinGeometry:
    """The launch a (batch, n, m) matrix takes.  ``aligned``: C's base is
    16-byte aligned (16-byte loads also need m % 4 == 0).  The cluster is the
    largest power of two, at most eight, that keeps the grid within
    ``MAX_BLOCKS`` blocks and that the rows can feed with one row a warp.
    Eight rows are requested ahead for a batch within L2 (a microsecond
    faster from a flushed L2 at n = 2048), four beyond it (faster once the
    matrix streams from device memory).  A tall, narrow matrix, whose clusters
    would occupy at most one block an SM with ``LONG_STRIPE`` rows or more a
    warp, takes two_launch, which fills the card whatever the shape; every
    other takes the cluster path (all as measured on an H100).  ``path``,
    ``cluster`` and ``ahead`` force a variant, to time one beside another."""
    if n < 1 or m < 1 or batch < 1:
        raise ValueError(f"col_min: empty matrix ({batch}, {n}, {m})")
    if path not in (None, "cluster", "two_launch"):
        raise ValueError(f"col_min: unknown path {path!r}")
    forced = not (cluster is None and ahead is None)
    if path == "two_launch" and forced:
        raise ValueError("col_min: two_launch takes no cluster or ahead")
    tiles = -(-m // TILE)
    warps = WARPS
    if cluster is None:
        cluster = 1
        while (cluster < MAX_CLUSTER and tiles * batch * cluster * 2 <= MAX_BLOCKS
               and cluster * warps < n):
            cluster *= 2
    if cluster not in (1, 2, 4, 8):
        raise ValueError(f"col_min: cluster {cluster}")
    rows_per_block = -(-n // cluster)  # ceil, then up to a multiple of warps
    rows_per_block = -(-rows_per_block // warps) * warps
    stripe = rows_per_block // warps
    blocks = tiles * cluster * batch
    if path is None:
        long_and_few = stripe >= LONG_STRIPE and blocks <= SMS
        path = "two_launch" if long_and_few and not forced else "cluster"
    if path == "two_launch":
        col_blocks = -(-m // TWO_LAUNCH_THREADS)
        chunks = max(1, min(n, 65535, -(-TWO_LAUNCH_TARGET_BLOCKS // (col_blocks * batch))))
        rows_per_chunk = -(-n // chunks)
        chunks = -(-n // rows_per_chunk)
        return ColMinGeometry(
            path=path, vector=False, tile=TWO_LAUNCH_THREADS, cluster=1,
            row_blocks=chunks, rows_per_block=rows_per_chunk,
            warps=TWO_LAUNCH_THREADS // 32, ahead=1, grid=(col_blocks, chunks, batch),
            smem_bytes=0,
        )
    if ahead is None:
        ahead = 8 if 4 * batch * n * m <= L2_BYTES and stripe >= 8 else 4
    if ahead not in (4, 8):
        raise ValueError(f"col_min: ahead {ahead}")
    return ColMinGeometry(
        path=path, vector=bool(aligned) and m % 4 == 0, tile=TILE, cluster=cluster,
        row_blocks=cluster, rows_per_block=rows_per_block, warps=warps, ahead=ahead,
        grid=(tiles * cluster, 1, batch), smem_bytes=(warps + 1) * TILE * 4,
    )


def col_min_plain(C: torch.Tensor) -> torch.Tensor:
    """(…, n, m) -> (…, m) column minimum."""
    return C.amin(-2)


def min_trick_plain(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(…, n, m), (…, n) -> (…, m): v_j = min_i (C_ij - u_i)."""
    return (C - u[..., :, None]).amin(-2)


def _nan_min(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's ``nan_min``: a NaN wins, of two equal values the first
    seen stays."""
    return torch.where((x < acc) | torch.isnan(x), x, acc)


def _fold_rows(X: torch.Tensor) -> torch.Tensor:
    """(…, r, c) -> (…, c): ``nan_min`` over the rows in order, +inf for
    r = 0."""
    acc = torch.full(X.shape[:-2] + X.shape[-1:], float("inf"), dtype=X.dtype)
    for i in range(X.shape[-2]):
        acc = _nan_min(acc, X[..., i, :])
    return acc


def col_min_by_tiles(
    C: torch.Tensor, u: Optional[torch.Tensor], geometry: ColMinGeometry
) -> torch.Tensor:
    """A plain transcription of the kernel's merge tree, for the CPU tests:
    per column tile, the stripe minima of each warp (rows first + w,
    first + w + warps, ... of its block, in order), the warps of a block in
    order, the blocks of a cluster in rank order, every step by ``nan_min``.
    On the two_launch path a stripe is a chunk's rows in order and the
    second launch merges the chunks in order."""
    g = geometry
    X = C if u is None else C - u[..., :, None]
    n, m = X.shape[-2:]
    out = torch.empty(X.shape[:-2] + (m,), dtype=X.dtype)
    for c0 in range(0, m, g.tile):
        cols = slice(c0, min(m, c0 + g.tile))
        total = None
        for rank in range(g.row_blocks):
            lo, hi = rank * g.rows_per_block, min(n, (rank + 1) * g.rows_per_block)
            if g.path == "cluster":
                stripes = [X[..., lo + w:hi:g.warps, cols] for w in range(g.warps)]
            else:
                stripes = [X[..., lo:hi, cols]]
            part = _fold_rows(stripes[0])
            for stripe in stripes[1:]:
                part = _nan_min(part, _fold_rows(stripe))
            total = part if total is None else _nan_min(total, part)
        out[..., cols] = total
    return out


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


def col_min_kernel(C: torch.Tensor, u: Optional[torch.Tensor] = None, **force) -> torch.Tensor:
    """The kernel on CUDA tensors: K1 without ``u``, K2 with it.  ``force``
    reaches ``col_min_geometry`` (``path``, ``cluster``, ``ahead``)."""
    what = "col_min" if u is None else "min_trick"
    if C.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {C.device}")
    Cb, ub, (B, n, m) = _as_batch(C, u, what)
    from ._lib import KERNEL_LIBS, check, ptr, stream_ptr

    if B > 65535:
        raise ValueError(f"{what}: batch {B} exceeds the kernel's grid limit 65535")
    g = col_min_geometry(n, m, aligned=Cb.data_ptr() % 16 == 0, batch=B, **force)
    lib = KERNEL_LIBS["colmin"].load()
    out = torch.empty((B, m), dtype=torch.float32, device=Cb.device)
    u_ptr = None if ub is None else ptr(ub)
    with torch.cuda.device(Cb.device):
        if g.path == "cluster":
            rc = lib.lapgnn_colmin_cluster(
                ptr(Cb), u_ptr, ptr(out), B, n, m, int(g.vector), g.ahead, g.cluster,
                g.warps, g.rows_per_block, stream_ptr(Cb.device),
            )
        else:
            part = torch.empty((B, g.row_blocks, m), dtype=torch.float32, device=Cb.device)
            rc = lib.lapgnn_colmin(
                ptr(Cb), u_ptr, ptr(part), ptr(out), B, n, m, g.row_blocks,
                g.rows_per_block, stream_ptr(Cb.device),
            )
    check(rc, f"colmin kernel ({g.path})")
    (col_min if u is None else min_trick).launches += 1
    return out if C.ndim == 3 else out[0]


def col_min(C: torch.Tensor) -> torch.Tensor:
    """K1: (n, m) -> (m,) or (B, n, m) -> (B, m) column minimum.

    Replaces ``ops/pallas/colmin.py:pallas_col_min``; bit-equal to
    ``col_min_plain`` (the sign of a mixed zero aside, see the module)."""
    if C.device.type == "cpu":
        return col_min_plain(C)
    return col_min_kernel(C)


def min_trick(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """K2: v_j = min_i (C_ij - u_i) for (n, m), (n,) or (B, n, m), (B, n).

    Replaces ``ops/pallas/colmin.py:pallas_min_trick``; C - u is never
    materialised.  Bit-equal to ``min_trick_plain`` (the sign of a mixed zero
    aside, see the module)."""
    if C.device.type == "cpu":
        return min_trick_plain(C, u)
    if u is None:
        raise TypeError("min_trick: u is required")
    return col_min_kernel(C, u)


col_min.launches = 0
min_trick.launches = 0
