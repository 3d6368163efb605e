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
]

Log = Optional[List[Tuple[str, int, str]]]


def log_collective(log: Log, op: str, t: torch.Tensor) -> None:
    if log is not None:
        log.append((op, t.numel(), str(t.dtype).replace("torch.", "")))


def _all_reduce(x: torch.Tensor, op, name: str, group, log: Log) -> torch.Tensor:
    t = x.reshape(1) if x.ndim == 0 else x
    t = t.to(torch.uint8) if t.dtype == torch.bool else t.clone()
    dist.all_reduce(t, op=op, group=group)
    log_collective(log, name, t)
    return t.to(x.dtype).reshape(x.shape)


def all_reduce_min(x: torch.Tensor, group=None, log: Log = None) -> torch.Tensor:
    """Elementwise minimum of ``x`` over the ranks of ``group``."""
    return _all_reduce(x, dist.ReduceOp.MIN, "all_reduce_min", group, log)


def all_reduce_max(x: torch.Tensor, group=None, log: Log = None) -> torch.Tensor:
    return _all_reduce(x, dist.ReduceOp.MAX, "all_reduce_max", group, log)


def all_reduce_sum(x: torch.Tensor, group=None, log: Log = None) -> torch.Tensor:
    return _all_reduce(x, dist.ReduceOp.SUM, "all_reduce_sum", group, log)


# ``all_gather_into_tensor`` under its newer name where there is one
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def all_gather(x: torch.Tensor, group=None, log: Log = None, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks ``x`` (equal shapes) concatenated along ``dim`` in
    rank order."""
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
