"""OneGNN and DualGNN training (loss, schedule and optimizer, trainers),
checkpoints and weight conversion."""

from .checkpoint import (
    build_model_from_meta,
    load_checkpoint,
    merge_params,
    msgpack_restore,
    msgpack_serialize,
    save_checkpoint,
)
from .convert import params_from_flax, params_to_flax
from .dual_trainer import DualTrainConfig, build_dual_gnn, train_dual_gnn
from .progressive import DatasetSpec, RoundRobinSampler, train_progressive
from .trainer import BucketBatcher, TrainConfig, train_one_gnn

__all__ = [
    "BucketBatcher",
    "DatasetSpec",
    "DualTrainConfig",
    "RoundRobinSampler",
    "TrainConfig",
    "build_dual_gnn",
    "build_model_from_meta",
    "load_checkpoint",
    "merge_params",
    "msgpack_restore",
    "msgpack_serialize",
    "params_from_flax",
    "params_to_flax",
    "save_checkpoint",
    "train_dual_gnn",
    "train_one_gnn",
    "train_progressive",
]
