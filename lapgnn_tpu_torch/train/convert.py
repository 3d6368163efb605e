"""flax OneGNN parameters -> the port's ``OneGNN`` state dict.

The inverse of ``lapgnn_tpu/train/convert_torch.py:convert_one_gnn_state_dict``
(:48): a flax ``Dense.kernel`` is (in, out), so ``Linear.weight = kernel.T``;
a flax ``LayerNorm`` ``scale`` becomes the torch LayerNorm's ``weight`` and
``bias`` stays ``bias``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["params_from_flax"]


def _lin(p: Dict[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = torch.from_numpy(np.array(p["kernel"], np.float32).T.copy())
    out[f"{prefix}.bias"] = torch.from_numpy(np.array(p["bias"], np.float32))


def _ln(p: Dict[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = torch.from_numpy(np.array(p["scale"], np.float32))
    out[f"{prefix}.bias"] = torch.from_numpy(np.array(p["bias"], np.float32))


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax OneGNN tree (``{"params": {...}}`` or the inner dict) of numpy
    arrays -> ``OneGNN`` state dict of CPU float32 tensors."""
    p = tree.get("params", tree)
    layers = sum(1 for k in p if k.startswith("block_"))
    sd: Dict[str, torch.Tensor] = {}
    _lin(p["input_proj"], "input_proj.0", sd)
    _ln(p["input_norm"], "input_proj.2", sd)
    for i in range(layers):
        blk = p[f"block_{i}"]
        _lin(blk["fc1"], f"blocks.{i}.fc1", sd)
        _lin(blk["fc2"], f"blocks.{i}.fc2", sd)
        _ln(blk["norm"], f"blocks.{i}.norm", sd)
    _lin(p["pre_out"], "pre_out", sd)
    _lin(p["head_fc1"], "row_out.0", sd)
    _lin(p["head_fc2"], "row_out.3", sd)
    _lin(p["edge_fc1"], "edge_mlp.0", sd)
    _lin(p["edge_fc2"], "edge_mlp.2", sd)
    _ln(p["message_norm"], "message_norm", sd)
    return sd
