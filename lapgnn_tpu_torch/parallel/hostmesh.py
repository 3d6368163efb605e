"""Multi-host mesh construction and host-local data feeding.

Port of ``lapgnn_tpu/parallel/hostmesh.py``.  The placement rule is the JAX
package's: the "model" axis partitions the rows of one cost matrix and its
ranks exchange O(n) collectives every solver round and GNN layer, latency-
critical traffic that must stay inside one host (NVLink, not the network);
the "data" axis carries batch parallelism and may span hosts.
``make_hierarchical_mesh`` therefore refuses a ``model`` axis that would
cross a host.

  * ``initialize_distributed()``: the multi-process entry point, from
    torchrun's variables (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``) in the roles of JAX's ``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``; with nothing set it does
    nothing.
  * ``global_batch_from_host_local``: a rank's block of the global batch
    from the data its process loaded, after a check that every rank loaded
    the same shape.

Ranks are numbered host-major (torchrun gives node r ranks r L .. r L + L - 1
for L processes a node), so ``LOCAL_WORLD_SIZE`` (or ``devices_per_host``,
which simulates hosts on one machine) is what groups them.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..device import resolve_device
from .collectives import all_gather
from .mesh import DEFAULT_TIMEOUT_S, Mesh, NamedSharding, P, make_mesh

__all__ = [
    "initialize_distributed",
    "make_hierarchical_mesh",
    "global_batch_from_host_local",
]


def _coordinator_from_env() -> Optional[str]:
    # `or None`: a set-but-empty variable means unset
    addr = os.environ.get("MASTER_ADDR") or None
    if addr is None:
        return None
    port = os.environ.get("MASTER_PORT") or None
    if port is None:
        raise ValueError("MASTER_ADDR is set but MASTER_PORT is not")
    return f"{addr}:{port}"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    timeout: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join the job's default process group; returns True if it is joined.

    Does nothing (returns False) unless a coordinator ``host:port`` is
    given, as an argument or by ``MASTER_ADDR`` and ``MASTER_PORT``; then
    ``num_processes`` and ``process_id`` (or ``WORLD_SIZE`` and ``RANK``) are
    required.  The backend follows ``device`` (default the GPU of
    ``LOCAL_RANK``): NCCL on CUDA, gloo on the CPU.  Call once per process,
    before ``make_mesh``."""
    addr = coordinator_address or _coordinator_from_env()
    if addr is None:
        return False
    if dist.is_initialized():
        return True
    np_ = num_processes or int(os.environ.get("WORLD_SIZE", "0"))
    pid = process_id if process_id is not None else int(os.environ.get("RANK", "-1"))
    if np_ <= 0 or pid < 0:
        raise ValueError(
            "coordinator_address given but num_processes/process_id "
            "missing (set WORLD_SIZE and RANK)"
        )
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = dev.index if dev.index is not None else int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=f"tcp://{addr}",
        world_size=np_, rank=pid, timeout=datetime.timedelta(seconds=timeout),
    )
    return True


def make_hierarchical_mesh(
    model: int = 1,
    devices_per_host: Optional[int] = None,
    axis_names: Tuple[str, str] = ("data", "model"),
    device: Optional[Union[str, torch.device]] = None,
    timeout: float = DEFAULT_TIMEOUT_S,
) -> Mesh:
    """(data x model) mesh with every model group inside one host.

    A host holds ``devices_per_host`` ranks (default ``LOCAL_WORLD_SIZE``,
    else the whole job: one host); ``model`` must divide it, so that the
    row-partition axis never crosses a host; ``data`` takes the rest, across
    hosts."""
    world = dist.get_world_size()
    per_host = devices_per_host or int(os.environ.get("LOCAL_WORLD_SIZE", "0")) or world
    if world % per_host != 0:
        raise ValueError(
            f"{world} devices not divisible by devices_per_host={per_host}"
        )
    if model <= 0 or per_host % model != 0:
        raise ValueError(
            f"model={model} must divide the per-host device count "
            f"{per_host}: the model (row) axis exchanges O(n) collectives "
            "per solver sweep / GNN layer and must stay on ICI, inside one "
            "host; shard the batch ('data') across hosts instead"
        )
    return make_mesh(world // model, model, device=device, axis_names=axis_names, timeout=timeout)


def global_batch_from_host_local(
    mesh: Mesh, local_batch, spec: P = P("data", "model", None)
) -> torch.Tensor:
    """This rank's block of the global batch, on ``mesh.device``.

    ``local_batch`` is the slice of the batch along 'data' that this rank's
    data coordinate owns (what its loader yields; in a one-process job, the
    whole batch): the global batch is those slices concatenated in data
    order.  Every rank's shape is checked against the others' (one all-gather
    of the shapes over the job); the dimensions that ``spec`` puts on other
    axes are then cut to this rank's block."""
    x = torch.as_tensor(local_batch)
    shape = torch.full((8,), -1, dtype=torch.int64, device=mesh.device)
    shape[: x.ndim] = torch.tensor(x.shape, dtype=torch.int64)
    shapes = all_gather(shape[None], None, mesh.log).cpu()
    if not bool((shapes == shapes[0]).all()):
        raise ValueError(
            "ranks hold host-local batches of different shapes: "
            f"{[[d for d in s if d >= 0] for s in shapes.tolist()]}"
        )
    local_spec = P(*(None if axis == "data" else axis for axis in spec))
    return NamedSharding(mesh, local_spec).local(x).to(mesh.device)
