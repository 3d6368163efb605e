"""The port's reader of the original PyTorch checkpoints
(``lapgnn_tpu_torch.train.convert_torch``) against the JAX package's.

The checkpoints are made here: ``torch.save`` of state dicts in the original
layout, in the three schemas that tests/test_torch_parity.py builds (a flat
OneGNN dict with an architecture tag, a flat untagged DualGNN dict, a
progressive dict with its model section under ``config``) and as a bare
state dict.  The port's OneGNN has the original layout, so its state dict is
one; the DualGNN one is made from a flax tree by the inverse of the JAX
converter.  Both converters must give the same tree, leaf for leaf and bit
for bit, and the same meta; the port's model built by
``load_reference_checkpoint`` must then forward as the flax model does on
the converted tree (both fed the port's features), within the tolerances of
tests/test_torch_model.py and tests/test_torch_dual_gnn.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapgnn_tpu.data.generators import FAMILIES
from lapgnn_tpu.models import DualGNN as FlaxDualGNN
from lapgnn_tpu.models import OneGNN as FlaxOneGNN
from lapgnn_tpu.train import convert_torch as jconvert
from lapgnn_tpu_torch.models import OneGNN
from lapgnn_tpu_torch.ops.features import (
    EDGE_FEATURE_DIM,
    NODE_FEATURE_DIM,
    graph_features,
    row_features,
)
from lapgnn_tpu_torch.train import convert_torch as tconvert

ONE = dict(hidden=32, layers=2)
DUAL = dict(hidden=32, layers=2, heads=4)
SCHEMAS = ["one_gnn_tagged", "dual_gnn_untagged", "progressive", "bare"]


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def _one_gnn_state_dict(hidden, layers, seed):
    torch.manual_seed(seed)
    return OneGNN(hidden=hidden, layers=layers, dropout=0.0).state_dict()


def _dual_gnn_state_dict(hidden, layers, heads):
    """A random flax DualGNN tree written in the original DualGNN's layout
    (the inverse of the JAX converter's mapping)."""
    model = FlaxDualGNN(hidden_dim=hidden, layers=layers, heads=heads, dropout=0.0)
    # the weights depend on the shapes only
    shapes = ((1, 6, 6, EDGE_FEATURE_DIM), (1, 6, NODE_FEATURE_DIM), (1, 6, NODE_FEATURE_DIM))
    init = jax.jit(model.init)(jax.random.key(1), *(jnp.zeros(s, jnp.float32) for s in shapes))
    p = jax.tree.map(np.asarray, init)["params"]
    sd = {}

    def lin(prefix, q):
        sd[f"{prefix}.weight"] = torch.from_numpy(q["kernel"].T.copy())
        if "bias" in q:
            sd[f"{prefix}.bias"] = torch.from_numpy(q["bias"].copy())

    def ln(prefix, q):
        sd[f"{prefix}.weight"] = torch.from_numpy(q["scale"].copy())
        sd[f"{prefix}.bias"] = torch.from_numpy(q["bias"].copy())

    lin("row_encoder.0", p["row_encoder_fc"])
    ln("row_encoder.2", p["row_encoder_norm"])
    lin("col_encoder.0", p["col_encoder_fc"])
    ln("col_encoder.2", p["col_encoder_norm"])
    lin("row_out", p["row_out"])
    lin("col_out", p["col_out"])
    for i in range(layers):
        q, pre = p[f"layer_{i}"], f"layers.{i}"
        for torch_name, flax_name in (("edge_mlp.0", "edge_fc1"), ("edge_mlp.3", "edge_fc2"),
                                      ("edge_mlp.5", "edge_fc3"), ("row_proj", "row_proj"),
                                      ("col_proj", "col_proj"), ("row_val", "row_val"),
                                      ("col_val", "col_val"), ("row_update.0", "row_update"),
                                      ("col_update.0", "col_update")):
            lin(f"{pre}.{torch_name}", q[flax_name])
        ln(f"{pre}.row_norm", q["row_norm"])
        ln(f"{pre}.col_norm", q["col_norm"])
        for side in ("row", "col"):
            sd[f"{pre}.attn_{side}_weight"] = torch.from_numpy(
                q[f"attn_{side}"].reshape(heads, -1).copy())
            sd[f"{pre}.attn_{side}_bias"] = torch.from_numpy(q[f"attn_{side}_bias"].copy())
    return sd


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reference_checkpoints")
    blobs = {
        "one_gnn_tagged": {
            "model_state_dict": _one_gnn_state_dict(ONE["hidden"], ONE["layers"], 0),
            "architecture": "one_gnn", "hidden_dim": ONE["hidden"], "layers": ONE["layers"],
            "dropout": 0.0, "row_feat_dim": 21, "features": "full",
        },
        "dual_gnn_untagged": {
            "model_state_dict": _dual_gnn_state_dict(**DUAL),
            "hidden_dim": DUAL["hidden"], "layers": DUAL["layers"], "heads": DUAL["heads"],
            "dropout": 0.0,
        },
        "progressive": {
            "model_state_dict": _one_gnn_state_dict(48, 3, 1),
            "config": {"hidden_dim": 48, "layers": 3, "dropout": 0.0},
        },
        "bare": _one_gnn_state_dict(64, 2, 2),
    }
    paths = {}
    for name, blob in blobs.items():
        paths[name] = tmp / f"{name}.pt"
        torch.save(blob, paths[name])
    return paths


@pytest.mark.parametrize("schema", SCHEMAS)
def test_convert_checkpoint_tree_and_meta_equal_jax(checkpoints, schema):
    j_tree, j_meta = jconvert.convert_checkpoint(checkpoints[schema])
    t_tree, t_meta = tconvert.convert_checkpoint(checkpoints[schema])
    _tree_equal(t_tree, j_tree)
    assert t_meta == j_meta


def test_schema_sniffing(checkpoints):
    assert tconvert.convert_checkpoint(checkpoints["dual_gnn_untagged"])[1]["architecture"] == "dual_gnn"
    meta = tconvert.convert_checkpoint(checkpoints["progressive"])[1]
    assert (meta["hidden"], meta["layers"], meta["dropout"]) == (48, 3, 0.0)
    meta = tconvert.convert_checkpoint(checkpoints["bare"])[1]
    assert (meta["architecture"], meta["hidden"], meta["layers"]) == ("one_gnn", 64, 2)


def test_state_dict_converters_equal_jax(checkpoints):
    sd = _one_gnn_state_dict(16, 3, 4)
    _tree_equal(tconvert.convert_one_gnn_state_dict(sd, 16, 3),
                jconvert.convert_one_gnn_state_dict(sd, 16, 3))
    sd = torch.load(checkpoints["dual_gnn_untagged"])["model_state_dict"]
    args = (DUAL["hidden"], DUAL["layers"], DUAL["heads"])
    _tree_equal(tconvert.convert_dual_gnn_state_dict(sd, *args),
                jconvert.convert_dual_gnn_state_dict(sd, *args))


def _cost(n, B=2, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([FAMILIES["uniform"](n, rng) for _ in range(B)]).astype(np.float32)


@pytest.mark.parametrize("schema", ["one_gnn_tagged", "progressive", "bare"])
def test_loaded_one_gnn_forwards_as_flax(checkpoints, schema):
    """atol 1e-5, as tests/test_torch_model.py holds a converted OneGNN."""
    tree, meta = jconvert.convert_checkpoint(checkpoints[schema])
    cost = _cost(16)
    feats = row_features(torch.from_numpy(cost)).numpy()
    flax = FlaxOneGNN(hidden=meta["hidden"], layers=meta["layers"], dropout=meta["dropout"],
                      topk=meta["topk"])
    want = np.asarray(jax.jit(flax.apply)(tree, jnp.asarray(feats), cost=jnp.asarray(cost))["u"])
    model = tconvert.load_reference_checkpoint(checkpoints[schema], device="cpu")
    assert not model.training and isinstance(model, OneGNN)
    with torch.no_grad():
        got = model(torch.from_numpy(feats), cost=torch.from_numpy(cost))["u"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_loaded_dual_gnn_forwards_as_flax(checkpoints):
    """atol 1e-5 max(1, max|w|), as tests/test_torch_dual_gnn.py holds a
    converted DualGNN (uniform instances)."""
    from lapgnn_tpu_torch.models import DualGNN

    tree, meta = jconvert.convert_checkpoint(checkpoints["dual_gnn_untagged"])
    gf = graph_features(torch.from_numpy(_cost(12)))
    flax = FlaxDualGNN(hidden_dim=meta["hidden"], layers=meta["layers"], heads=meta["heads"],
                       dropout=meta["dropout"])
    want = jax.jit(flax.apply)(tree, *(t.numpy() for t in (gf.edge_feat, gf.row_feat, gf.col_feat)))
    model = tconvert.load_reference_checkpoint(checkpoints["dual_gnn_untagged"], device="cpu")
    assert isinstance(model, DualGNN)
    with torch.no_grad():
        got = model(gf.edge_feat, gf.row_feat, gf.col_feat)
    for k in ("u", "v_hint"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())))


def test_load_reference_checkpoint_defaults_to_the_gpu(checkpoints, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconvert.load_reference_checkpoint(checkpoints["bare"])
