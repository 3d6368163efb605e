"""OneGNN training (loss, schedule and optimizer, trainers), checkpoints and
weight conversion."""

from .checkpoint import (
    build_model_from_meta,
    load_checkpoint,
    merge_params,
    msgpack_restore,
    msgpack_serialize,
    save_checkpoint,
)
from .convert import params_from_flax, params_to_flax
from .progressive import DatasetSpec, RoundRobinSampler, train_progressive
from .trainer import BucketBatcher, TrainConfig, train_one_gnn

__all__ = [
    "BucketBatcher",
    "DatasetSpec",
    "RoundRobinSampler",
    "TrainConfig",
    "build_model_from_meta",
    "load_checkpoint",
    "merge_params",
    "msgpack_restore",
    "msgpack_serialize",
    "params_from_flax",
    "params_to_flax",
    "save_checkpoint",
    "train_one_gnn",
    "train_progressive",
]
