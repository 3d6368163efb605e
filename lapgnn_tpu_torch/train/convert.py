"""flax OneGNN / DualGNN parameters <-> the port's state dicts.

``params_from_flax`` is the inverse of
``lapgnn_tpu/train/convert_torch.py:convert_one_gnn_state_dict`` (:48): a
flax ``Dense.kernel`` is (in, out), so ``Linear.weight = kernel.T``; a flax
``LayerNorm`` ``scale`` becomes the torch LayerNorm's ``weight`` and ``bias``
stays ``bias``.  ``params_to_flax`` maps back, keys sorted as JAX's tree utilities
leave the trained tree the JAX trainer saves, so
``params_to_flax(params_from_flax(t)) == t`` and a checkpoint the port
writes is one the JAX package reads.  A DualGNN tree (it has
``row_encoder_fc``) maps onto ``models.DualGNN``: ``layer_{i}`` becomes
``layer.{i}``, a bias-free Dense (the projections) has no bias, and the
attention weights ``attn_row`` / ``attn_col`` (heads, 3, head_dim) and their
biases are copied as they are.  A OneGNN with the global context carries
``ctx_fc1``, ``ctx_fc2`` and ``ctx_norm`` under the same names in both.
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


def _arr(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


# DualGNN: the Dense and LayerNorm submodules of a layer, and the bare
# parameters, by their flax names (the port's attributes carry the same).
_DUAL_LAYER_DENSE = ("row_proj", "col_proj", "row_val", "col_val", "edge_fc1",
                     "edge_fc2", "edge_fc3", "row_update", "col_update")
_DUAL_LAYER_NORM = ("row_norm", "col_norm")
_DUAL_LAYER_PARAMS = ("attn_row", "attn_col", "attn_row_bias", "attn_col_bias")
_DUAL_TOP_DENSE = ("row_encoder_fc", "col_encoder_fc", "row_out", "col_out")
_DUAL_TOP_NORM = ("row_encoder_norm", "col_encoder_norm")


def _dual_from_flax(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}

    def lin(q, prefix):
        sd[f"{prefix}.weight"] = torch.from_numpy(np.array(q["kernel"], np.float32).T.copy())
        if "bias" in q:
            sd[f"{prefix}.bias"] = _arr(q["bias"])

    for name in _DUAL_TOP_DENSE:
        lin(p[name], name)
    for name in _DUAL_TOP_NORM:
        _ln(p[name], name, sd)
    layers = sum(1 for k in p if k.startswith("layer_"))
    for i in range(layers):
        q = p[f"layer_{i}"]
        for name in _DUAL_LAYER_DENSE:
            lin(q[name], f"layer.{i}.{name}")
        for name in _DUAL_LAYER_NORM:
            _ln(q[name], f"layer.{i}.{name}", sd)
        for name in _DUAL_LAYER_PARAMS:
            sd[f"layer.{i}.{name}"] = _arr(q[name])
    return sd


def _dual_to_flax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    def lin(prefix):
        out = {"kernel": _np(sd[f"{prefix}.weight"]).T.copy()}
        if f"{prefix}.bias" in sd:
            out["bias"] = _np(sd[f"{prefix}.bias"])
        return out

    def ln(prefix):
        return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}

    p: Dict[str, Any] = {name: lin(name) for name in _DUAL_TOP_DENSE}
    p.update({name: ln(name) for name in _DUAL_TOP_NORM})
    layers = len({k.split(".")[1] for k in sd if k.startswith("layer.")})
    for i in range(layers):
        q: Dict[str, Any] = {name: lin(f"layer.{i}.{name}") for name in _DUAL_LAYER_DENSE}
        q.update({name: ln(f"layer.{i}.{name}") for name in _DUAL_LAYER_NORM})
        q.update({name: _np(sd[f"layer.{i}.{name}"]) for name in _DUAL_LAYER_PARAMS})
        p[f"layer_{i}"] = q
    return {"params": _sorted(p)}


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax OneGNN or DualGNN tree (``{"params": {...}}`` or the inner dict)
    of numpy arrays -> ``OneGNN`` / ``DualGNN`` state dict of CPU float32
    tensors.  A OneGNN tree without the top-k refinement's leaves (a model
    initialised without a cost) gives a state dict without them, to load
    with ``strict=False``."""
    p = tree.get("params", tree)
    if "row_encoder_fc" in p:
        return _dual_from_flax(p)
    layers = sum(1 for k in p if k.startswith("block_"))
    sd: Dict[str, torch.Tensor] = {}
    _lin(p["input_proj"], "input_proj.0", sd)
    _ln(p["input_norm"], "input_proj.2", sd)
    if "ctx_fc1" in p:  # OneGNN(context=True)
        _lin(p["ctx_fc1"], "ctx_fc1", sd)
        _lin(p["ctx_fc2"], "ctx_fc2", sd)
        _ln(p["ctx_norm"], "ctx_norm", sd)
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
    """``OneGNN`` or ``DualGNN`` state dict -> the flax tree
    ``{"params": {...}}`` of float32 numpy arrays, every level's keys
    sorted.  ``refine=False`` leaves out OneGNN's top-k refinement leaves,
    as flax's tree of a model initialised without a cost has none."""
    sd = state_dict
    if "row_encoder_fc.weight" in sd:
        return _dual_to_flax(sd)

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
    if "ctx_fc1.weight" in sd:
        p["ctx_fc1"] = lin("ctx_fc1")
        p["ctx_fc2"] = lin("ctx_fc2")
        p["ctx_norm"] = ln("ctx_norm")
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
