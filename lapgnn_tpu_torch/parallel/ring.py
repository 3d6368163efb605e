"""Explicit ring collectives over a mesh axis (point-to-point sends).

Port of ``lapgnn_tpu/parallel/ring.py``, where the ring is a ``shard_map``
over ``lax.ppermute``.  Here it is S - 1 steps of ``dist.batch_isend_irecv``:
each rank sends its running partial to the next rank of the axis, receives
the previous rank's, and folds it in with ``torch.minimum``.  After the last
step every rank holds the elementwise minimum over the axis, bit-equal to
``collectives.all_reduce_min``.  Each hop is logged as ``ring_send``.

gloo sends only CPU tensors, so on CUDA tensors the ring needs NCCL.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..ops.cuda.colmin import min_trick
from .collectives import log_collective
from .mesh import Mesh

__all__ = ["ring_all_reduce_min", "ring_min_trick"]


def _ring_min(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    group = mesh.group(axis)
    ranks = dist.get_process_group_ranks(group)
    size, k = len(ranks), mesh.coordinate(axis)
    nxt, prv = ranks[(k + 1) % size], ranks[(k - 1) % size]
    partial, acc = x.contiguous(), x
    for _ in range(size - 1):
        received = torch.empty_like(partial)
        ops = [dist.P2POp(dist.isend, partial, nxt, group),
               dist.P2POp(dist.irecv, received, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        log_collective(mesh.log, "ring_send", partial)
        partial, acc = received, torch.minimum(acc, received)
    return acc


def ring_all_reduce_min(mesh: Mesh, axis: str = "model") -> Callable[[torch.Tensor], torch.Tensor]:
    """Build f(partial) -> the elementwise minimum of every rank's partial
    along ``axis``; each rank passes its own (JAX passes the stack of every
    shard's partial, split over the axis)."""
    return lambda x: _ring_min(x, mesh, axis)


def ring_min_trick(
    mesh: Mesh, axis: str = "model"
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Row-sharded min-trick with the ring combine: f(C_blk, u_blk) -> v,
    the rank's (n/S, m) rows of C and (n/S,) of u in, the (m,) column duals
    min_i (C_ij - u_i) out on every rank.  The local pass is kernel K2
    (``ops.cuda.min_trick``) on a CUDA tensor."""
    return lambda C_blk, u_blk: _ring_min(min_trick(C_blk, u_blk), mesh, axis)
