"""The port's OneGNN, weight conversion and msgpack reader against the JAX
package's flax model and flax's own deserialiser."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from lapgnn_tpu.data.generators import FAMILIES
from lapgnn_tpu.models import OneGNN as FlaxOneGNN
from lapgnn_tpu.ops.features import row_features
from lapgnn_tpu.train.convert_torch import convert_one_gnn_state_dict
from lapgnn_tpu_torch.models import OneGNN
from lapgnn_tpu_torch.train import (
    build_model_from_meta,
    load_checkpoint,
    msgpack_restore,
    params_from_flax,
)

CKPT = Path(__file__).resolve().parent.parent / "artifacts" / "one_gnn_default"


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _tree_equal(a, b, path=""):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)), path
    if isinstance(a, dict):
        assert list(a.keys()) == list(b.keys()), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


def _flax_model(hidden, layers, topk, n, seed, B=2):
    model = FlaxOneGNN(hidden=hidden, layers=layers, dropout=0.0, topk=topk)
    rng = np.random.default_rng(seed)
    cost = np.stack([FAMILIES["uniform"](n, rng) for _ in range(B)]).astype(np.float32)
    feats = np.asarray(row_features(jnp.asarray(cost)))
    params = model.init(jax.random.key(seed), jnp.asarray(feats), cost=jnp.asarray(cost))
    params = jax.tree_util.tree_map(np.asarray, params)
    return model, params, cost, feats


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("n", [12, 24])
def test_random_one_gnn_matches_flax(refine, n):
    """Random-init flax OneGNN (hidden 32, 2 layers, top-k 8) carried across
    by params_from_flax: atol 1e-5 (flax LayerNorm takes E[x²]-E[x]², torch
    two passes; matmuls sum in another order)."""
    model, params, cost, feats = _flax_model(32, 2, 8, n, seed=n)
    want = model.apply(params, jnp.asarray(feats), cost=jnp.asarray(cost) if refine else None)
    tm = OneGNN(hidden=32, layers=2, dropout=0.0, topk=8)
    tm.load_state_dict(params_from_flax(params))
    tm.eval()
    with torch.no_grad():
        got = tm(_t(feats), cost=_t(cost) if refine else None)["u"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want["u"]), atol=1e-5, rtol=0)


def test_topk_wider_than_row_and_unbatched_input():
    """k > n clips to n; an (n, F) input gains a batch axis, as in flax."""
    model, params, cost, feats = _flax_model(16, 1, 32, 10, seed=3, B=1)
    want = model.apply(params, jnp.asarray(feats[0]), cost=jnp.asarray(cost))
    tm = OneGNN(hidden=16, layers=1, dropout=0.0, topk=32).eval()
    tm.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        got = tm(_t(feats[0]), cost=_t(cost))["u"]
    assert got.shape == (1, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want["u"]), atol=1e-5, rtol=0)


def test_params_from_flax_inverts_convert_torch():
    """convert_one_gnn_state_dict(params_from_flax(p)) == p, bit for bit."""
    _, params, _, _ = _flax_model(32, 3, 8, 12, seed=5)
    sd = params_from_flax(params)
    back = convert_one_gnn_state_dict(sd, hidden=32, layers=3)
    _tree_equal(jax.tree_util.tree_map(np.asarray, back), params)
    tm = OneGNN(hidden=32, layers=3)
    assert set(tm.state_dict()) == set(sd)


def test_msgpack_reader_matches_flax_on_default_checkpoint():
    raw = (CKPT / "params.msgpack").read_bytes()
    _tree_equal(msgpack_restore(raw), serialization.msgpack_restore(raw))


def test_msgpack_reader_scalar_and_container_types():
    tree = {
        "a": np.arange(6, dtype=np.int32).reshape(2, 3),
        "b": {"c": np.float64(2.5), "d": np.zeros((0,), np.float32)},
        "e": [1, -3, 300, -70000, 2**40, True, None, "x" * 40],
        "f": 1.25,
        "g": b"\x00\x01",
        "h": np.ones((70, 3), np.float16),
    }
    raw = serialization.msgpack_serialize(tree)
    _tree_equal(msgpack_restore(raw), serialization.msgpack_restore(raw))


def test_msgpack_reader_rejects_truncated_data():
    raw = (CKPT / "params.msgpack").read_bytes()
    with pytest.raises(ValueError):
        msgpack_restore(raw[:-7])


def test_default_checkpoint_builds_full_width_model():
    params, meta, opt = load_checkpoint(CKPT)
    assert opt is None
    model = build_model_from_meta(meta)
    model.load_state_dict(params_from_flax(params))
    assert (model.hidden, model.layers, model.topk) == (192, 4, 16)


def test_default_checkpoint_forward_matches_flax():
    """The real one_gnn_default at full width (hidden 192, 4 layers, top-k 16)."""
    params, meta, _ = load_checkpoint(CKPT)
    fm = FlaxOneGNN(hidden=192, layers=4, dropout=0.0, topk=16)
    cost = FAMILIES["noisy_linear"](40, np.random.default_rng(6)).astype(np.float32)[None]
    feats = np.asarray(row_features(jnp.asarray(cost)))
    want = fm.apply(serialization.msgpack_restore((CKPT / "params.msgpack").read_bytes()),
                    jnp.asarray(feats), cost=jnp.asarray(cost))
    tm = build_model_from_meta(meta).eval()
    tm.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        got = tm(_t(feats), cost=_t(cost))["u"]
    scale = float(np.abs(np.asarray(want["u"])).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want["u"]), atol=1e-5 * max(1.0, scale))


def test_unported_variants_raise():
    with pytest.raises(NotImplementedError):
        OneGNN(context=True)
    with pytest.raises(NotImplementedError):
        OneGNN(topk_impl="iter")
    # DualGNN is ported: its meta builds the model (tests/test_torch_dual_gnn.py)
    from lapgnn_tpu_torch.models import DualGNN

    assert isinstance(build_model_from_meta({"architecture": "dual_gnn"}), DualGNN)
    with pytest.raises(ValueError):
        build_model_from_meta({"architecture": "nope"})
