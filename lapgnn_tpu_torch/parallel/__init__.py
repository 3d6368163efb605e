"""Distribution layer: the (data x model) and (row x col) meshes over
``torch.distributed`` ranks, their logged collectives (with gradients),
row-sharded serving, data-parallel training and the 2-D edge-partitioned
DualGNN.

Port of ``lapgnn_tpu/parallel``."""

from .dual import (
    assert_no_edge_tensor_gather,
    dual_mesh,
    make_sharded_dual_eval_step,
    make_sharded_dual_predict,
    make_sharded_dual_train_step,
)
from .hostmesh import (
    global_batch_from_host_local,
    initialize_distributed,
    make_hierarchical_mesh,
)
from .mesh import Mesh, NamedSharding, P, batch_sharding, local_rows, make_mesh, replicated
from .ring import ring_all_reduce_min, ring_min_trick
from .sharded import make_dp_train_step, make_sharded_predict, shmap_col_min, shmap_min_trick

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
    "make_dp_train_step",
    "make_sharded_predict",
    "shmap_col_min",
    "shmap_min_trick",
    "assert_no_edge_tensor_gather",
    "dual_mesh",
    "make_sharded_dual_eval_step",
    "make_sharded_dual_predict",
    "make_sharded_dual_train_step",
]
