"""Read checkpoints of the original PyTorch system into this port.

Port of ``lapgnn_tpu/train/convert_torch.py``.  The original system saves
``state_dict`` checkpoints in three schemas (a flat OneGNN dict with an
architecture tag, a flat DualGNN dict without one, a progressive dict with
its model section under ``config``) or as a bare state dict.  These
functions map them onto the flax parameter tree that the JAX package and
this port's checkpoints share (numpy leaves, the JAX converter's output bit
for bit), so that ``train.convert.params_from_flax`` loads them into the
port's models; ``load_reference_checkpoint`` does all of it.

Usage:
  tree = convert_one_gnn_state_dict(state_dict, hidden=64, layers=2)
  tree, meta = convert_checkpoint("model_best.pt")     # schema-sniffing
  model = load_reference_checkpoint("model_best.pt")   # a built nn.Module
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "convert_one_gnn_state_dict",
    "convert_dual_gnn_state_dict",
    "convert_checkpoint",
    "load_reference_checkpoint",
]


def _lin(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": np.ascontiguousarray(np.asarray(sd[f"{prefix}.weight"]).T)}
    if f"{prefix}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{prefix}.bias"])
    return out


def _ln(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {
        "scale": np.asarray(sd[f"{prefix}.weight"]),
        "bias": np.asarray(sd[f"{prefix}.bias"]),
    }


def _to_numpy_state_dict(sd) -> Dict[str, np.ndarray]:
    return {
        k: np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)
        for k, t in sd.items()
    }


def convert_one_gnn_state_dict(state_dict, hidden: int, layers: int) -> Dict[str, Any]:
    """OneGNN state dict of the original layout -> flax tree {"params": ...}."""
    sd = _to_numpy_state_dict(state_dict)
    params: Dict[str, Any] = {
        "input_proj": _lin(sd, "input_proj.0"),
        "input_norm": _ln(sd, "input_proj.2"),
        "pre_out": _lin(sd, "pre_out"),
        "head_fc1": _lin(sd, "row_out.0"),
        "head_fc2": _lin(sd, "row_out.3"),
        "edge_fc1": _lin(sd, "edge_mlp.0"),
        "edge_fc2": _lin(sd, "edge_mlp.2"),
        "message_norm": _ln(sd, "message_norm"),
    }
    for i in range(layers):
        params[f"block_{i}"] = {
            "fc1": _lin(sd, f"blocks.{i}.fc1"),
            "fc2": _lin(sd, f"blocks.{i}.fc2"),
            "norm": _ln(sd, f"blocks.{i}.norm"),
        }
    return {"params": params}


def convert_dual_gnn_state_dict(
    state_dict, hidden: int, layers: int, heads: int
) -> Dict[str, Any]:
    """DualGNN state dict of the original layout -> flax tree {"params": ...}."""
    sd = _to_numpy_state_dict(state_dict)
    hd = hidden // heads
    params: Dict[str, Any] = {
        "row_encoder_fc": _lin(sd, "row_encoder.0"),
        "row_encoder_norm": _ln(sd, "row_encoder.2"),
        "col_encoder_fc": _lin(sd, "col_encoder.0"),
        "col_encoder_norm": _ln(sd, "col_encoder.2"),
        "row_out": _lin(sd, "row_out"),
        "col_out": _lin(sd, "col_out"),
    }
    for i in range(layers):
        p = f"layers.{i}"
        params[f"layer_{i}"] = {
            "edge_fc1": _lin(sd, f"{p}.edge_mlp.0"),
            "edge_fc2": _lin(sd, f"{p}.edge_mlp.3"),
            "edge_fc3": _lin(sd, f"{p}.edge_mlp.5"),
            "row_proj": _lin(sd, f"{p}.row_proj"),
            "col_proj": _lin(sd, f"{p}.col_proj"),
            "row_val": _lin(sd, f"{p}.row_val"),
            "col_val": _lin(sd, f"{p}.col_val"),
            # (heads, 3 * head_dim), the thirds concatenated -> (heads, 3, hd)
            "attn_row": np.asarray(sd[f"{p}.attn_row_weight"]).reshape(heads, 3, hd),
            "attn_col": np.asarray(sd[f"{p}.attn_col_weight"]).reshape(heads, 3, hd),
            "attn_row_bias": np.asarray(sd[f"{p}.attn_row_bias"]),
            "attn_col_bias": np.asarray(sd[f"{p}.attn_col_bias"]),
            "row_update": _lin(sd, f"{p}.row_update.0"),
            "col_update": _lin(sd, f"{p}.col_update.0"),
            "row_norm": _ln(sd, f"{p}.row_norm"),
            "col_norm": _ln(sd, f"{p}.col_norm"),
        }
    return {"params": params}


def convert_checkpoint(path) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load an original ``.pt`` checkpoint, sniffing its schema.

    The three schemas and a bare state dict (taken as a OneGNN with the
    original defaults).  A checkpoint with no architecture tag is a DualGNN
    when its state dict has bipartite attention keys.  Returns (flax tree,
    meta for ``train.build_model_from_meta``)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        sd = blob["model_state_dict"]
        cfg = blob.get("config", {}) or {}
        # progressive checkpoints keep the model section itself under
        # 'config'; others may nest it under 'model'
        model_cfg = cfg.get("model", cfg) if isinstance(cfg, dict) else {}

        def pick(*keys, default=None):
            for container in (blob, model_cfg):
                for k in keys:
                    v = container.get(k)
                    if v is not None:
                        return v
            return default

        arch = pick("architecture")
        if arch is None:
            is_dual = any(k.startswith("layers.0.attn") for k in sd)
            arch = "dual_gnn" if is_dual else "one_gnn"
        hidden = int(pick("hidden_dim", "hidden", default=64))
        layers = int(pick("layers", default=2))
        heads = int(pick("heads", default=4))
        # not `or`: dropout 0.0 is a value
        dropout = float(pick("dropout", default=0.1))
    else:  # bare state_dict
        sd = blob
        arch, hidden, layers, heads, dropout = "one_gnn", 64, 2, 4, 0.1

    if arch == "one_gnn":
        params = convert_one_gnn_state_dict(sd, hidden, layers)
        meta = {
            "architecture": "one_gnn",
            "hidden": hidden,
            "layers": layers,
            "dropout": dropout,
            "topk": 16,
            "use_cost_refinement": True,
            "converted_from": str(path),
        }
    else:
        params = convert_dual_gnn_state_dict(sd, hidden, layers, heads)
        meta = {
            "architecture": "dual_gnn",
            "hidden": hidden,
            "layers": layers,
            "heads": heads,
            "dropout": dropout,
            "converted_from": str(path),
        }
    return params, meta


def load_reference_checkpoint(
    path, device: Optional[Union[str, torch.device]] = None
) -> torch.nn.Module:
    """The port's model, built from an original checkpoint's meta and
    loaded with its weights, in eval mode on ``device`` (default the GPU)."""
    from .checkpoint import build_model_from_meta
    from .convert import params_from_flax

    tree, meta = convert_checkpoint(path)
    model = build_model_from_meta(meta)
    model.load_state_dict(params_from_flax(tree))
    return model.to(resolve_device(device)).eval()
