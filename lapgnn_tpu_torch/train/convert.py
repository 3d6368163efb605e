"""flax OneGNN parameters <-> the port's ``OneGNN`` state dict.

``params_from_flax`` is the inverse of
``lapgnn_tpu/train/convert_torch.py:convert_one_gnn_state_dict`` (:48): a
flax ``Dense.kernel`` is (in, out), so ``Linear.weight = kernel.T``; a flax
``LayerNorm`` ``scale`` becomes the torch LayerNorm's ``weight`` and ``bias``
stays ``bias``.  ``params_to_flax`` maps back, keys sorted as JAX's tree utilities
leave the trained tree the JAX trainer saves, so
``params_to_flax(params_from_flax(t)) == t`` and a checkpoint the port
writes is one the JAX package reads.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["params_from_flax", "params_to_flax"]


def _lin(p: Dict[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = torch.from_numpy(np.array(p["kernel"], np.float32).T.copy())
    out[f"{prefix}.bias"] = torch.from_numpy(np.array(p["bias"], np.float32))


def _ln(p: Dict[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = torch.from_numpy(np.array(p["scale"], np.float32))
    out[f"{prefix}.bias"] = torch.from_numpy(np.array(p["bias"], np.float32))


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax OneGNN tree (``{"params": {...}}`` or the inner dict) of numpy
    arrays -> ``OneGNN`` state dict of CPU float32 tensors.  A tree without
    the top-k refinement's leaves (a model initialised without a cost) gives
    a state dict without them, to load with ``strict=False``."""
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
    if "edge_fc1" in p:  # flax makes these only when initialised with a cost
        _lin(p["edge_fc1"], "edge_mlp.0", sd)
        _lin(p["edge_fc2"], "edge_mlp.2", sd)
        _ln(p["message_norm"], "message_norm", sd)
    return sd


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def params_to_flax(state_dict: Dict[str, torch.Tensor], refine: bool = True) -> Dict[str, Any]:
    """``OneGNN`` state dict -> the flax tree ``{"params": {...}}`` of
    float32 numpy arrays, every level's keys sorted.  ``refine=False``
    leaves out the top-k refinement's leaves, as flax's tree of a model
    initialised without a cost has none."""
    sd = state_dict

    def lin(prefix):
        return {"kernel": _np(sd[f"{prefix}.weight"]).T.copy(), "bias": _np(sd[f"{prefix}.bias"])}

    def ln(prefix):
        return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}

    layers = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    p: Dict[str, Any] = {"input_proj": lin("input_proj.0"), "input_norm": ln("input_proj.2")}
    for i in range(layers):
        p[f"block_{i}"] = {
            "fc1": lin(f"blocks.{i}.fc1"),
            "fc2": lin(f"blocks.{i}.fc2"),
            "norm": ln(f"blocks.{i}.norm"),
        }
    p["pre_out"] = lin("pre_out")
    if refine:
        p["edge_fc1"] = lin("edge_mlp.0")
        p["edge_fc2"] = lin("edge_mlp.2")
        p["message_norm"] = ln("message_norm")
    p["head_fc1"] = lin("row_out.0")
    p["head_fc2"] = lin("row_out.3")
    return {"params": _sorted(p)}


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree
