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
from .loss import dual_gnn_loss, greedy_primal_upper, masked_v_proj, one_gnn_loss
from .progressive import DatasetSpec, RoundRobinSampler, train_progressive
from .schedule import make_optimizer, warmup_cosine
from .trainer import BucketBatcher, State, TrainConfig, train_one_gnn

__all__ = [
    "BucketBatcher",
    "DatasetSpec",
    "DualTrainConfig",
    "RoundRobinSampler",
    "State",
    "TrainConfig",
    "build_dual_gnn",
    "build_model_from_meta",
    "dual_gnn_loss",
    "greedy_primal_upper",
    "load_checkpoint",
    "make_optimizer",
    "masked_v_proj",
    "merge_params",
    "msgpack_restore",
    "msgpack_serialize",
    "one_gnn_loss",
    "params_from_flax",
    "params_to_flax",
    "save_checkpoint",
    "train_dual_gnn",
    "train_one_gnn",
    "train_progressive",
    "warmup_cosine",
]
