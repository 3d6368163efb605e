"""The (data x model) mesh over the ranks of a ``torch.distributed`` job.

Port of ``lapgnn_tpu/parallel/mesh.py``.  The axes are the JAX package's:

  "data"  - batch data parallelism (instances)
  "model" - the ROWS of each cost matrix, split in contiguous blocks

A ``Mesh`` wraps a ``torch.distributed.device_mesh.DeviceMesh`` built over
the current process group with ``mesh_dim_names=("data", "model")``: rank
r sits at (r // model, r % model), so the ranks of one model group are
consecutive (one host's, under torchrun).  Each axis has its own process
group, made with the mesh's timeout, so a collective that hangs fails.  The
mesh also carries ``log``: every collective of ``parallel.collectives`` made
on its groups appends ``(op, numel, dtype)`` to it, which is what
``parallel.solver.assert_no_matrix_allgather`` reads.

JAX places arrays by ``NamedSharding(mesh, P(...))`` and GSPMD slices them;
here each rank holds only its block.  ``NamedSharding.local`` (and
``local_rows``) cut a rank's block out of an array that every rank holds,
contiguously and evenly: a dimension that its axis does not divide raises.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = [
    "DEFAULT_TIMEOUT_S",
    "Mesh",
    "NamedSharding",
    "P",
    "batch_sharding",
    "local_rows",
    "make_mesh",
    "replicated",
]

# Seconds a collective may wait for its peers before it fails.  Every
# collective of the package moves O(n) data and the ranks do equal work
# between them, so a wait this long means a rank is gone.
DEFAULT_TIMEOUT_S = 120.0


class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: one entry a
    dimension, the mesh axis that splits it or None."""

    def __new__(cls, *spec: Optional[str]):
        return super().__new__(cls, spec)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _backend_options(backend: str, timeout: datetime.timedelta):
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
    elif backend == "gloo":
        opts = dist.ProcessGroupGloo._Options()
    else:
        raise ValueError(f"unsupported backend {backend!r} (nccl or gloo)")
    opts._timeout = timeout
    return backend, opts


@dataclass
class Mesh:
    """A (data x model) grid of the job's ranks; ``device`` is this rank's."""

    device_mesh: "torch.distributed.device_mesh.DeviceMesh"
    device: torch.device
    log: List[Tuple[str, int, str]] = field(default_factory=list)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    def _dim(self, axis: str) -> int:
        return self.axis_names.index(axis)

    @property
    def shape(self) -> Dict[str, int]:
        return {a: self.device_mesh.size(i) for i, a in enumerate(self.axis_names)}

    def size(self, axis: str) -> int:
        return self.device_mesh.size(self._dim(axis))

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    @property
    def ranks(self) -> torch.Tensor:
        """The global rank at each (data, model) position."""
        return self.device_mesh.mesh


def make_mesh(
    data: int = -1,
    model: int = 1,
    device: Optional[Union[str, torch.device]] = None,
    axis_names: Tuple[str, str] = ("data", "model"),
    timeout: float = DEFAULT_TIMEOUT_S,
) -> Mesh:
    """Build a (data x model) mesh over every rank of the current process
    group; ``data=-1`` takes what ``model`` leaves.  ``device`` is this
    rank's (default: the GPU of its local index; ``"cpu"`` on purpose)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call initialize_distributed() "
            "or torch.distributed.init_process_group first"
        )
    n = dist.get_world_size()
    if data == -1:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} needs {data*model} devices, have {n}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    from torch.distributed.device_mesh import init_device_mesh

    opts = _backend_options(dist.get_backend(), datetime.timedelta(seconds=timeout))
    device_mesh = init_device_mesh(
        dev.type, (data, model), mesh_dim_names=axis_names,
        backend_override={a: opts for a in axis_names},
    )
    return Mesh(device_mesh, dev)


@dataclass(frozen=True)
class NamedSharding:
    """Where each dimension of an array lives on ``mesh`` (``spec``)."""

    mesh: Mesh
    spec: P

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``x``, which every rank holds whole: each
        dimension named in ``spec`` split evenly and contiguously over its
        axis."""
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            parts, k = self.mesh.size(axis), self.mesh.coordinate(axis)
            size = x.shape[dim]
            if size % parts != 0:
                raise ValueError(
                    f"dimension {dim} of size {size} does not split evenly over "
                    f"the {parts} ranks of axis {axis!r}"
                )
            step = size // parts
            x = x.narrow(dim, k * step, step)
        return x


def batch_sharding(mesh: Mesh, *, shard_n: bool = False) -> NamedSharding:
    """A (B, n, n) cost batch: B over 'data', with ``shard_n`` the ROW axis
    over 'model' as well (every sharded consumer's layout)."""
    if shard_n:
        return NamedSharding(mesh, P("data", "model", None))
    return NamedSharding(mesh, P("data", None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def local_rows(C: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """This rank's block of rows of C ((n, m) or (B, n, m)): rank k along
    ``axis`` of S holds rows [k n / S, (k + 1) n / S)."""
    spec = (None,) * (C.ndim - 2) + (axis, None)
    return NamedSharding(mesh, P(*spec)).local(C)
