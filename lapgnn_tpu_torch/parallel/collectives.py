"""The collectives of the parallel package, each logged.

The JAX package leaves its collectives to GSPMD and checks the compiled HLO
for what they move.  Here every collective is an explicit call of this
module, on a process group, and appends ``(op, numel, dtype)`` to the
caller's ``log`` (``Mesh.log``): the number of elements it delivers to each
rank.  That log is what ``parallel.solver.assert_no_matrix_allgather`` and
the tests read.

Each function returns a new tensor and leaves its input alone.  Min and max
are exact in any order, so ``all_reduce_min`` / ``all_reduce_max`` and the
argmin combine give every rank the bits the unsharded reduction gives;
``all_reduce_sum`` adds in the backend's order.

gloo reduces and broadcasts CUDA tensors but gathers only CPU ones, so on a
CUDA tensor under gloo ``all_gather`` is an all-reduce: each rank writes the
bits of its block into zeros at its offset and the integer sum over ranks
is every block's bits, exact.

Gradients.  When autograd records (grad mode on and the input requiring a
gradient), ``all_reduce_sum``, ``all_reduce_min`` / ``all_reduce_max``,
``reduce_min`` and ``all_gather`` are ``torch.autograd.Function``s, and
``pvary`` is their conjugate.  Every rank computes the same scalar loss and
calls backward on it, and the rule is JAX's for replicated ("invariant")
and per-rank ("varying") values:

  * a tensor replicated over a group holds, on every rank, the whole
    gradient of the loss with respect to it; a per-rank tensor holds the
    gradient with respect to its own block;
  * ``all_reduce_sum`` (varying in, replicated out): its backward is the
    identity, since every rank's output gradient is already the whole one;
  * ``pvary`` (replicated in, identity forward, varying out) marks where a
    replicated tensor enters a per-rank computation: each rank's gradient
    is then its own block's share, and the backward SUMs the shares;
  * ``all_gather``'s backward takes the rank's own block of the gradient;
  * a MIN / MAX (``all_reduce_min`` / ``all_reduce_max`` elementwise over
    the ranks, ``reduce_min`` over a dimension split over them) sends the
    gradient only to the entries that equal the global extreme, split
    evenly among all of them on every rank, the count from one SUM: the
    rule of ``torch.amin`` and of JAX's ``reduce_min`` JVP.

A parameter, replicated everywhere, therefore collects on each rank the
gradient of that rank's share of the computation, and the ranks' gradients
are SUMed over every axis on which that share differs.  Backward passes log
as ``<op>.backward``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "all_gather",
    "all_reduce_max",
    "all_reduce_min",
    "all_reduce_sum",
    "argmin_combine",
    "float_of_ordered",
    "log_collective",
    "ordered_int32",
    "pvary",
    "reduce_min",
]

Log = Optional[List[Tuple[str, int, str]]]


def log_collective(log: Log, op: str, t: torch.Tensor) -> None:
    if log is not None:
        log.append((op, t.numel(), str(t.dtype).replace("torch.", "")))


def _all_reduce(x: torch.Tensor, op, name: str, group, log: Log) -> torch.Tensor:
    t = x.reshape(1) if x.ndim == 0 else x
    t = t.to(torch.uint8) if t.dtype == torch.bool else t
    t = t.contiguous().clone()  # a new tensor; NCCL reduces only contiguous ones
    dist.all_reduce(t, op=op, group=group)
    log_collective(log, name, t)
    return t.to(x.dtype).reshape(x.shape)


def _records(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, log):
        return _all_reduce(x, dist.ReduceOp.SUM, "all_reduce_sum", group, log)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Vary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, log):
        ctx.group, ctx.log = group, log
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, dist.ReduceOp.SUM, "pvary.backward", ctx.group, ctx.log), None, None


class _Extreme(torch.autograd.Function):
    """MIN or MAX over the ranks, of ``t`` itself (``dim`` None) or of its
    local extremes along ``dim``."""

    @staticmethod
    def forward(ctx, t, dim, op, group, log):
        name = "all_reduce_min" if op == "min" else "all_reduce_max"
        local = t if dim is None else (t.amin(dim) if op == "min" else t.amax(dim))
        out = _all_reduce(local, dist.ReduceOp.MIN if op == "min" else dist.ReduceOp.MAX,
                          name, group, log)
        ctx.save_for_backward(t, out)
        ctx.dim, ctx.group, ctx.log, ctx.name = dim, group, log, name
        return out

    @staticmethod
    def backward(ctx, g):
        t, out = ctx.saved_tensors
        dim = ctx.dim
        if dim is not None:
            out, g = out.unsqueeze(dim), g.unsqueeze(dim)
        hit = (t == out).to(g.dtype)
        count = hit if dim is None else hit.sum(dim, keepdim=True)
        count = _all_reduce(count, dist.ReduceOp.SUM, ctx.name + ".backward", ctx.group, ctx.log)
        return g * hit / count, None, None, None, None


def all_reduce_min(x: torch.Tensor, group=None, log: Log = None) -> torch.Tensor:
    """Elementwise minimum of ``x`` over the ranks of ``group``."""
    if _records(x):
        return _Extreme.apply(x, None, "min", group, log)
    return _all_reduce(x, dist.ReduceOp.MIN, "all_reduce_min", group, log)


def all_reduce_max(x: torch.Tensor, group=None, log: Log = None) -> torch.Tensor:
    if _records(x):
        return _Extreme.apply(x, None, "max", group, log)
    return _all_reduce(x, dist.ReduceOp.MAX, "all_reduce_max", group, log)


def all_reduce_sum(x: torch.Tensor, group=None, log: Log = None) -> torch.Tensor:
    """Elementwise sum of ``x`` over the ranks of ``group``; the result is
    replicated, so its backward is the identity."""
    if _records(x):
        return _Sum.apply(x, group, log)
    return _all_reduce(x, dist.ReduceOp.SUM, "all_reduce_sum", group, log)


def reduce_min(t: torch.Tensor, dim: int, group=None, log: Log = None) -> torch.Tensor:
    """``t.amin(dim)`` where ``dim`` is split over the ranks of ``group``:
    the local minima, then one MIN all-reduce; amin's gradient over every
    rank's entries."""
    if _records(t):
        return _Extreme.apply(t, dim, "min", group, log)
    return _all_reduce(t.amin(dim), dist.ReduceOp.MIN, "all_reduce_min", group, log)


def pvary(x: torch.Tensor, group=None, log: Log = None) -> torch.Tensor:
    """``x``, replicated over ``group``, handed to a per-rank computation:
    the identity forward, a SUM of the ranks' gradients backward."""
    if _records(x):
        return _Vary.apply(x, group, log)
    return x


# ``all_gather_into_tensor`` under its newer name where there is one
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _gather(x: torch.Tensor, group, log: Log, dim: int) -> torch.Tensor:
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    src = src.movedim(dim, 0).contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        bits = src.view(_BITS[src.element_size()])
        out = torch.zeros((size,) + tuple(bits.shape), dtype=bits.dtype, device=x.device)
        out[rank] = bits
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        out = out.view(src.dtype)
    else:
        out = torch.empty((size * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=x.device)
        _gather_into(out, src, group=group)
    log_collective(log, "all_gather", out)
    out = out.reshape((size * src.shape[0],) + tuple(src.shape[1:])).movedim(0, dim)
    return out.to(x.dtype)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, log, dim):
        ctx.block, ctx.dim = x.shape[dim], dim
        ctx.rank = dist.get_rank(group)
        return _gather(x, group, log, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.block, ctx.block), None, None, None


def all_gather(x: torch.Tensor, group=None, log: Log = None, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks ``x`` (equal shapes) concatenated along ``dim`` in
    rank order; the backward takes this rank's block of the gradient."""
    if _records(x):
        return _Gather.apply(x, group, log, dim)
    return _gather(x, group, log, dim)


def ordered_int32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 keys in the order of the values: -0.0 and +0.0 one
    key, every NaN the least key (NaN wins a minimum, as in ``torch.min``)."""
    v = torch.where(v == 0, 0.0, v)
    b = v.view(torch.int32)
    k = torch.where(b >= 0, b, b ^ 0x7FFFFFFF)
    return torch.where(torch.isnan(v), torch.iinfo(torch.int32).min, k)


def float_of_ordered(k: torch.Tensor) -> torch.Tensor:
    """The float32 of an ``ordered_int32`` key (any integer dtype)."""
    k32 = k.to(torch.int32)
    return torch.where(k32 >= 0, k32, k32 ^ 0x7FFFFFFF).view(torch.float32)


def argmin_combine(
    values: torch.Tensor, rows: torch.Tensor, group=None, log: Log = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global ``torch.min(C, dim=0)`` of a row-sharded C from each rank's
    local one: ``values`` its minima, ``rows`` their GLOBAL row indices.
    Returns the minima and the lowest global row attaining each, on every
    rank.  float32 takes one all-reduce of int64 keys (the value's order-
    preserving int32 above, the row below); the minimum comes back with a
    zero's sign and a NaN's payload made canonical.  Other dtypes take two:
    the minimum, then the lowest row holding it."""
    rows = rows.to(torch.int64)
    if values.dtype == torch.float32:
        key = (ordered_int32(values).to(torch.int64) << 32) | rows
        key = all_reduce_min(key, group, log)
        return float_of_ordered(key >> 32), key & 0xFFFFFFFF
    best = all_reduce_min(values, group, log)
    hit = (values == best) | (torch.isnan(values) & torch.isnan(best))
    big = torch.iinfo(torch.int64).max
    return best, all_reduce_min(torch.where(hit, rows, big), group, log)
