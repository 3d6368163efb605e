"""The seed policy's Sinkhorn ladder: CUDA kernel and plain version.

Replaces the loop of ``lapgnn_tpu/ops/sinkhorn.py:sinkhorn_refine`` (:91),
``jnp.logsumexp`` passes that XLA fuses, with no Pallas kernel behind it.
Eagerly the port ran each half-pass as about twelve PyTorch operations (a
broadcast subtract and a divide into n^2 temporaries, ``torch.logsumexp``'s
pieces, the scaling), some 800 launches and a blocking copy a rung for one
call.  The kernel (``csrc/sinkhorn.cu``) runs the whole ladder and the two
exact min-trick projections that end it in one cooperative launch: the
temperatures are made on the card from the launch's relative ones and the
device scale, so the call makes no host sync.

Design: each of the grid's blocks (one an SM) owns ``rows`` consecutive
rows for both half-passes.  The row half-pass is a warp a row, each lane
taking every 32nd group of four columns (16-byte loads), v from shared
memory, an online logsumexp (running maximum, scaled sum) a lane merged
across the warp by shuffles.  The column half-pass needs only the block's
own u: a thread a group of four columns folds the block's rows four at a
time into a partial (maximum, scaled sum) a column, written to a (blocks,
n) scratch; after a grid barrier each block merges the partials of its own
columns (``slices`` threads a column, then a tree over the slices) and
writes v; a second barrier hands v to the next row half-pass.  Layouts
(``sinkhorn_geometry``): resident, the block's rows of the ladder's matrix
in shared memory for the whole launch (up to n = 2,700 or so on 132 SMs),
or streamed, the rows read from device memory (L2) every half-pass.

Bound on this card: one read of the (B, n, n) float32 matrix a half-pass and
two in the projections, ``(2 * rungs * iters + 2) * B * n^2 * 4`` bytes at
3.35 TB/s (0.33 ms at n = 2048 and the default ladder, were every read from
device memory; the matrix fits the 50 MB L2 there), beside the float32
work, a subtract, an IEEE divide, an ``expf`` and the running sums an
element a half-pass.

Agreement: the arithmetic is the eager loop's (subtract, divide by the
temperature, full-precision ``expf`` / ``logf``; a NaN in a logsumexp wins,
then +inf, and all -inf gives -inf, as ``torch.logsumexp`` gives them), but
the logsumexps sum in another order (``sinkhorn_by_blocks`` transcribes
it), so u and v agree with the plain loop to within ``RTOL`` times the
instance's largest magnitude of the ladder's matrix (``tolerance``): each
half-pass's sums round a few float32 ulps apart, and scaled back by the
temperature that is a few ulps of |v - C|; the transcription read at most
1.9e-7 of it against the eager loop (the four families at n = 64, 300 and
700, batch 1 and 3: about 1.5 ulp of max|C|), so the bound leaves 50 times
that for longer sums and the card's own ``expf``.  The
projections are minima of the same elementwise differences as the eager
``amin`` s, so given the same ladder v they are bit-equal (the sign of a
zero aside).  A CUDA float32 tensor launches the kernel (or raises); a CPU
tensor takes the plain version.  The wrapper counts its launches in the
tracer's ``launch.sinkhorn_ladder``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from .augment import MAX_SMEM
from .colmin import SMS

__all__ = [
    "RTOL",
    "LadderGeometry",
    "sinkhorn_by_blocks",
    "sinkhorn_geometry",
    "sinkhorn_ladder",
    "sinkhorn_ladder_kernel",
    "sinkhorn_ladder_plain",
    "sinkhorn_smem_bytes",
    "tolerance",
]

THREADS = 512  # csrc/sinkhorn.cu's kThreads
MAX_RUNGS = 16  # csrc/sinkhorn.cu's kMaxRungs
STATIC_SMEM = 128  # at least the kernel's static shared memory (lapgnn_sinkhorn_static_smem)
LAYOUTS = ("streamed", "resident")  # csrc/sinkhorn.cu's layouts, in order
# The kernel against the plain loop: |difference| <= RTOL * max|cost_r| an instance.
RTOL = 1e-5


@dataclass(frozen=True)
class LadderGeometry:
    """The cooperative launch: ``blocks`` blocks of ``THREADS`` threads, one
    an SM, each owning ``rows`` consecutive rows (the last block fewer);
    ``resident`` keeps a block's rows of the ladder's matrix in its shared
    memory; ``smem_bytes`` of dynamic shared memory a block."""

    blocks: int
    rows: int
    resident: bool
    smem_bytes: int


def _up4(x: int) -> int:
    return (x + 3) & ~3


def sinkhorn_smem_bytes(n: int, rows: int, resident: bool) -> int:
    """A block's dynamic shared memory: v (padded to four columns), its rows'
    u, a (maximum, sum) pair a thread for the merge and, resident, its rows
    of the matrix at the padded width."""
    return 4 * (_up4(n) + _up4(rows)) + 8 * THREADS + (4 * rows * _up4(n) if resident else 0)


def sinkhorn_geometry(n: int, sms: int = SMS, layout: Optional[str] = None) -> LadderGeometry:
    """The launch at n columns on ``sms`` SMs: the rows spread evenly over
    at most one block an SM (every block holds a row), the resident layout
    where it fits ``MAX_SMEM`` (or the ``layout`` forced: a resident layout
    that does not fit raises).  An n whose v does not fit shared memory, or
    whose columns a block exceed the merge's threads, raises."""
    if n < 1:
        raise ValueError(f"sinkhorn_ladder: n = {n}")
    rows = -(-n // min(n, sms))
    blocks = -(-n // rows)
    if -(-n // blocks) > THREADS:
        raise ValueError(f"sinkhorn_ladder: n = {n} has more than {THREADS} columns a block")
    if sinkhorn_smem_bytes(n, rows, False) + STATIC_SMEM > MAX_SMEM:
        raise ValueError(f"sinkhorn_ladder: n = {n} does not fit a block's shared memory")
    fits = sinkhorn_smem_bytes(n, rows, True) + STATIC_SMEM <= MAX_SMEM
    if layout is None:
        resident = fits
    elif layout not in LAYOUTS:
        raise ValueError(f"sinkhorn_ladder: unknown layout {layout!r}")
    else:
        resident = layout == "resident"
        if resident and not fits:
            raise ValueError(f"sinkhorn_ladder: n = {n} does not fit the resident layout")
    return LadderGeometry(blocks=blocks, rows=rows, resident=resident,
                          smem_bytes=sinkhorn_smem_bytes(n, rows, resident))


def tolerance(cost_r: torch.Tensor) -> torch.Tensor:
    """(B, 1): how far the kernel's u and v may lie from the plain loop's,
    ``RTOL`` times each instance's largest |cost_r|."""
    return RTOL * cost_r.abs().amax((-2, -1))[:, None]


# ------------------------------------------------- the kernel's order, on the CPU


def _nan_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)  # NaN-propagating, as csrc/sinkhorn.cu's nan_max


def _add4(m, s, z0, z1, z2, z3):
    """``lse_add4``: four values into a (maximum, scaled sum) pair."""
    M = _nan_max(_nan_max(m, _nan_max(z0, z1)), _nan_max(z2, z3))
    fin = torch.isfinite(M)
    e = lambda z: torch.exp(z - M)  # noqa: E731
    s = torch.where(fin, s * torch.exp(m - M) + (e(z0) + e(z1)) + (e(z2) + e(z3)),
                    torch.zeros_like(s))
    return M, s


def _merge(m, s, m2, s2):
    """``lse_merge``: two (maximum, scaled sum) pairs into one."""
    M = _nan_max(m, m2)
    s = torch.where(torch.isfinite(M), s * torch.exp(m - M) + s2 * torch.exp(m2 - M),
                    torch.zeros_like(s))
    return M, s


def _value(m, s):
    """``lse_value``: the logsumexp of a pair."""
    return torch.where(torch.isfinite(m), torch.log(s) + m, m)


def _row_lse_by_lanes(z: torch.Tensor) -> torch.Tensor:
    """The row half-pass's logsumexp over the last axis of (..., n) z: lane l
    folds groups of four columns l, l + 32, ... (columns past n count as
    -inf), then the lanes merge by the xor butterfly 16, 8, 4, 2, 1."""
    n = z.shape[-1]
    groups = -(-n // 4)
    t = -(-groups // 32)
    pad = torch.full(z.shape[:-1] + (t * 32 * 4 - n,), -torch.inf, dtype=z.dtype)
    zz = torch.cat([z, pad], -1).reshape(z.shape[:-1] + (t, 32, 4))
    m = torch.full(z.shape[:-1] + (32,), -torch.inf, dtype=z.dtype)
    s = torch.zeros_like(m)
    for k in range(t):
        g = zz[..., k, :, :]
        m, s = _add4(m, s, g[..., 0], g[..., 1], g[..., 2], g[..., 3])
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        m, s = _merge(m, s, m[..., lane ^ off], s[..., lane ^ off])
    return _value(m[..., 0], s[..., 0])


def _col_partials(z: torch.Tensor, rows: int, blocks: int):
    """The column half-pass's partials of (B, n, n) z: block b folds its
    ``rows`` rows four at a time (rows past its last count as -inf) into a
    (maximum, scaled sum) a column.  Returns two (B, blocks, n) tensors."""
    B, n, m_cols = z.shape
    chunks = -(-rows // 4)
    per_block = []
    for b in range(blocks):
        blk = z[:, b * rows: min((b + 1) * rows, n)]
        fill = torch.full((B, chunks * 4 - blk.shape[1], m_cols), -torch.inf, dtype=z.dtype)
        per_block.append(torch.cat([blk, fill], 1))
    zb = torch.stack(per_block, 1).reshape(B, blocks, chunks, 4, m_cols)
    m = torch.full((B, blocks, m_cols), -torch.inf, dtype=z.dtype)
    s = torch.zeros_like(m)
    for c in range(chunks):
        g = zb[:, :, c]
        m, s = _add4(m, s, g[:, :, 0], g[:, :, 1], g[:, :, 2], g[:, :, 3])
    return m, s


def _merge_partials(m: torch.Tensor, s: torch.Tensor, blocks: int) -> torch.Tensor:
    """The merge of (B, blocks, n) partials: the block owning column c has
    ``width`` (cols rounded up to a power of two) threads a slice and
    THREADS / width slices; slice p merges partials p, p + slices, ... in
    turn, then the slices merge as a tree, slice p taking slice p + half
    for half = slices / 2, ..., 1."""
    B, G, n = m.shape
    cols = -(-n // blocks)
    width = 1
    while width < cols:
        width *= 2
    slices = THREADS // width
    steps = -(-G // slices)
    fill = steps * slices - G
    mp = torch.cat([m, torch.full((B, fill, n), -torch.inf, dtype=m.dtype)], 1)
    sp = torch.cat([s, torch.zeros((B, fill, n), dtype=s.dtype)], 1)
    mp = mp.reshape(B, steps, slices, n)
    sp = sp.reshape(B, steps, slices, n)
    am = torch.full((B, slices, n), -torch.inf, dtype=m.dtype)
    asum = torch.zeros_like(am)
    for k in range(steps):
        am, asum = _merge(am, asum, mp[:, k], sp[:, k])
    half = slices // 2
    while half:
        am[:, :half], asum[:, :half] = _merge(am[:, :half], asum[:, :half],
                                              am[:, half: 2 * half], asum[:, half: 2 * half])
        half //= 2
    return _value(am[:, 0], asum[:, 0])


def sinkhorn_by_blocks(
    cost_r: torch.Tensor,
    cost: torch.Tensor,
    u0: torch.Tensor,
    scale: torch.Tensor,
    eps_rel: Sequence[float],
    iters: int,
    sms: int = SMS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A plain transcription of the kernel's order on the CPU, for the
    tests: the same arithmetic an element as the eager loop, the row
    logsumexps by lanes and the column ones by blocks' partials and their
    merge (``sinkhorn_geometry(n, sms)``'s blocks and rows), in float32.
    The minima (v's start and the projections) are order-free."""
    B, n, _ = cost_r.shape
    g = sinkhorn_geometry(n, sms)
    u = u0.to(torch.float32)
    v = (cost_r - u[..., :, None]).amin(-2)
    for eps_r in eps_rel:
        eps = torch.tensor(eps_r, dtype=torch.float32) * scale[:, None, None]
        for _ in range(iters):
            u = -eps[..., 0] * _row_lse_by_lanes((v[..., None, :] - cost_r) / eps)
            m, s = _col_partials((u[..., :, None] - cost_r) / eps, g.rows, g.blocks)
            v = -eps[:, :, 0] * _merge_partials(m, s, g.blocks)
    u = (cost - v[..., None, :]).amin(-1)
    v = (cost - u[..., :, None]).amin(-2)
    return u, v


# ------------------------------------------------------------- the wrapper


def sinkhorn_ladder_plain(cost_r, cost, u0, scale, eps_rel, iters):
    """The eager ladder (``ops.sinkhorn.sinkhorn_ladder_eager``)."""
    from ..sinkhorn import sinkhorn_ladder_eager

    return sinkhorn_ladder_eager(cost_r, cost, u0.to(torch.float32), scale, eps_rel, iters)


_OCCUPANCY: Dict[Tuple[int, int, bool, bool], int] = {}


def _check(cost_r, cost, u0, scale, eps_rel, iters) -> None:
    for name, t in (("cost_r", cost_r), ("cost", cost), ("u0", u0), ("scale", scale)):
        if t.dtype != torch.float32:
            raise TypeError(f"sinkhorn_ladder: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sinkhorn_ladder: {name} must be contiguous")
    if cost.ndim != 3 or cost.shape[-1] != cost.shape[-2] or cost.shape[-1] < 1:
        raise ValueError(f"sinkhorn_ladder: takes a (B, n, n) batch, got {tuple(cost.shape)}")
    B, n = cost.shape[0], cost.shape[-1]
    if cost_r.shape != cost.shape or u0.shape != (B, n) or scale.shape != (B,):
        raise ValueError(
            f"sinkhorn_ladder: shapes cost_r {tuple(cost_r.shape)}, cost {tuple(cost.shape)}, "
            f"u0 {tuple(u0.shape)}, scale {tuple(scale.shape)} do not match")
    if len(eps_rel) > MAX_RUNGS or iters < 0:
        raise ValueError(f"sinkhorn_ladder: {len(eps_rel)} rungs (at most {MAX_RUNGS}), "
                         f"{iters} sweeps a rung")
    if cost.device.type != "cuda":
        raise ValueError(f"sinkhorn_ladder: unsupported device {cost.device}")
    for name, t in (("cost_r", cost_r), ("u0", u0), ("scale", scale)):
        if t.device != cost.device:
            raise ValueError(f"sinkhorn_ladder: {name} is on {t.device}, cost on {cost.device}")


def sinkhorn_ladder_kernel(
    cost_r: torch.Tensor,
    cost: torch.Tensor,
    u0: torch.Tensor,
    scale: torch.Tensor,
    eps_rel: Sequence[float],
    iters: int,
    layout: Optional[str] = None,
    keep_ladder: bool = False,
):
    """The kernel on CUDA float32 tensors: (u, v), each (B, n); with
    ``keep_ladder`` also the ladder's last v, before the projections."""
    _check(cost_r, cost, u0, scale, eps_rel, iters)
    from ._lib import KERNEL_LIBS, launched, ptr, sm_count, stream_ptr

    B, n = cost.shape[0], cost.shape[-1]
    dev = cost.device
    lib = KERNEL_LIBS["sinkhorn"].load()
    vec = n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (cost_r, cost))
    with torch.cuda.device(dev):
        g = sinkhorn_geometry(n, sm_count(dev), layout)
        key = (dev.index, g.smem_bytes, g.resident, vec)
        if key not in _OCCUPANCY:
            _OCCUPANCY[key] = lib.lapgnn_sinkhorn_occupancy(g.smem_bytes, g.resident, vec)
        if _OCCUPANCY[key] < 1:
            raise RuntimeError(f"sinkhorn_ladder: the card holds no block at n = {n} "
                               f"({_OCCUPANCY[key]})")
        u = torch.empty((B, n), dtype=torch.float32, device=dev)
        v = torch.empty((B, n), dtype=torch.float32, device=dev)
        work = torch.empty(lib.lapgnn_sinkhorn_work_bytes(B, n, g.blocks), dtype=torch.uint8,
                           device=dev)
        rungs = (ctypes.c_float * max(1, len(eps_rel)))(*eps_rel)
        rc = lib.lapgnn_sinkhorn(ptr(cost_r), ptr(cost), ptr(u0), ptr(scale), ptr(u), ptr(v),
                                 ptr(work), rungs, len(eps_rel), iters, B, n, g.blocks, g.rows,
                                 g.resident, vec, stream_ptr(dev))
    launched(rc, "sinkhorn_ladder kernel", "sinkhorn_ladder")
    if keep_ladder:
        off = lib.lapgnn_sinkhorn_ladder_offset()
        ladder = work[off: off + 4 * B * n].view(torch.float32).view(B, n)
        return u, v, ladder
    return u, v


def sinkhorn_ladder(
    cost_r: torch.Tensor,
    cost: torch.Tensor,
    u0: torch.Tensor,
    scale: torch.Tensor,
    eps_rel: Sequence[float],
    iters: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sinkhorn's temperature ladder and its two exact projections: from
    (B, n) row duals ``u0``, ``iters`` sweeps a rung over (B, n, n)
    ``cost_r`` at temperatures ``eps_rel[r] * scale`` ((B,) ``scale``), then
    u = amin_j(cost - v), v = amin_i(cost - u) on the true ``cost``.
    Returns (u, v), (B, n) each.  A CPU tensor takes the plain version; any
    other launches the kernel."""
    if cost.device.type == "cpu":
        return sinkhorn_ladder_plain(cost_r, cost, u0, scale, eps_rel, iters)
    return sinkhorn_ladder_kernel(cost_r, cost, u0, scale, eps_rel, iters)
