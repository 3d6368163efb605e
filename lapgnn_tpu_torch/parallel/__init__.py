"""Distribution layer: the (data x model) mesh over ``torch.distributed``
ranks, its logged collectives, and row-sharded serving.

Port of ``lapgnn_tpu/parallel``.  Not ported yet (training under a mesh):
``make_dp_train_step`` and the 2-D edge-partitioned DualGNN of
``parallel/dual.py`` (``dual_mesh``, ``make_sharded_dual_predict``,
``make_sharded_dual_train_step``, ``make_sharded_dual_eval_step``,
``assert_no_edge_tensor_gather``), with ``train_dual_gnn(mesh=)`` and
``cli/train_dual_gnn.py --mesh-2d`` as their callers."""

from .hostmesh import (
    global_batch_from_host_local,
    initialize_distributed,
    make_hierarchical_mesh,
)
from .mesh import Mesh, NamedSharding, P, batch_sharding, local_rows, make_mesh, replicated
from .ring import ring_all_reduce_min, ring_min_trick
from .sharded import make_sharded_predict, shmap_col_min, shmap_min_trick

__all__ = [
    "Mesh",
    "NamedSharding",
    "P",
    "batch_sharding",
    "local_rows",
    "make_mesh",
    "replicated",
    "initialize_distributed",
    "make_hierarchical_mesh",
    "global_batch_from_host_local",
    "ring_all_reduce_min",
    "ring_min_trick",
    "make_sharded_predict",
    "shmap_col_min",
    "shmap_min_trick",
]
