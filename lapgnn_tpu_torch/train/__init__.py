"""Checkpoint loading and weight conversion (training is not ported yet)."""

from .checkpoint import build_model_from_meta, load_checkpoint, msgpack_restore
from .convert import params_from_flax

__all__ = ["build_model_from_meta", "load_checkpoint", "msgpack_restore", "params_from_flax"]
