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
    """Every OneGNN variant of the JAX package is ported now: ``context=True``
    and ``topk_impl="iter"`` build (held to flax below); an unknown top-k
    form, or an unknown architecture in a checkpoint's meta, raises."""
    assert OneGNN(context=True).context and OneGNN(topk_impl="iter").topk_impl == "iter"
    with pytest.raises(ValueError):
        OneGNN(topk_impl="sort")
    # DualGNN is ported: its meta builds the model (tests/test_torch_dual_gnn.py)
    from lapgnn_tpu_torch.models import DualGNN

    assert isinstance(build_model_from_meta({"architecture": "dual_gnn"}), DualGNN)
    with pytest.raises(ValueError):
        build_model_from_meta({"architecture": "nope"})


# ---------------------------------------------------------------- context, mask, iterative top-k


_row_features = jax.jit(row_features)


@pytest.fixture(scope="module")
def context_model():
    """A random flax OneGNN with the global context and the top-k
    refinement (hidden 16, 2 layers, top-k 4), a batch of 3 instances at
    n = 10 and a row mask (instance 1 keeps 6 rows, instance 2 every other
    row), and its apply jitted (one compile with a mask, one without)."""
    model = FlaxOneGNN(hidden=16, layers=2, dropout=0.0, topk=4, context=True)
    rng = np.random.default_rng(21)
    cost = np.stack([FAMILIES[f](10, rng) for f in ("uniform", "tie", "block")]).astype(np.float32)
    feats = np.asarray(_row_features(jnp.asarray(cost)))
    init = jax.jit(lambda key, f, c: model.init(key, f, cost=c))
    params = jax.tree_util.tree_map(np.asarray, init(jax.random.key(4), jnp.asarray(feats),
                                                     jnp.asarray(cost)))
    mask = np.ones((3, 10), bool)
    mask[1, 6:] = False
    mask[2, 1::2] = False
    apply = jax.jit(lambda p, f, c, m: model.apply(p, f, cost=c, mask=m))
    return params, apply, cost, feats, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("topk_impl", ["top_k", "iter"])
def test_context_and_mask_match_flax(context_model, masked, topk_impl):
    """OneGNN(context=True) with the top-k refinement, with and without a
    row mask, in both top-k forms: within 1e-6·max(1, max|u|) of flax
    (float32 sums in another order; the widths are small, so fewer terms
    meet in a sum than in the 1e-5 tests above).  Masked rows are exactly 0."""
    params, apply, cost, feats, mask = context_model
    want = np.asarray(apply(params, jnp.asarray(feats), jnp.asarray(cost),
                            jnp.asarray(mask) if masked else None)["u"])
    tm = OneGNN(hidden=16, layers=2, dropout=0.0, topk=4, context=True, topk_impl=topk_impl)
    tm.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        got = tm(_t(feats), cost=_t(cost), mask=_t(mask) if masked else None)["u"].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(1.0, float(np.abs(want).max())))
    if masked:
        assert not got[~mask].any()


def test_masked_rows_do_not_move_the_context(context_model):
    """A padded instance (garbage in its padded rows, masked) gives its
    valid rows the u of the unpadded instance, up to the gauge: the
    masked mean and max pools, the top-k refinement and the head see only
    the valid rows (u is centred over all rows, as flax's, so the valid rows
    shift by one constant)."""
    params, _, cost, feats, _ = context_model
    tm = OneGNN(hidden=16, layers=2, dropout=0.0, topk=4, context=True)
    tm.load_state_dict(params_from_flax(params))
    n = 6
    small_cost = cost[:1, :n, :n]
    small_feats = np.asarray(_row_features(jnp.asarray(small_cost)))
    pad_feats = np.concatenate([small_feats, np.full((1, 4, small_feats.shape[-1]), 7.0, np.float32)], 1)
    pad_cost = np.full((1, 10, 10), 1e3, np.float32)
    pad_cost[:, :n, :n] = small_cost
    mask = np.arange(10)[None] < n
    with torch.no_grad():
        want = tm(_t(small_feats), cost=_t(small_cost))["u"].numpy()
        got = tm(_t(pad_feats), cost=_t(pad_cost[:, :, :n]), mask=_t(mask))["u"].numpy()
    shift = got[0, :n] - want[0]
    np.testing.assert_allclose(shift, shift.mean(), rtol=0, atol=1e-5)
    assert not got[0, n:].any()


def test_topk_iter_equals_top_k_bit_for_bit():
    """The iterative top k against ``torch.topk`` and against the JAX
    package's ``_topk_smallest_iter``, bit for bit, on rows full of ties
    (the tie family, small integers), with +inf entries and whole +inf rows
    (masked rows), k from 1 to the row's length; and a model in each form
    gives bit-equal u."""
    from lapgnn_tpu.models.one_gnn import _topk_smallest_iter as j_iter
    from lapgnn_tpu_torch.models.one_gnn import _topk_smallest_iter

    rng = np.random.default_rng(8)
    rows = np.concatenate([
        FAMILIES["tie"](9, rng).astype(np.float32),
        rng.integers(0, 3, size=(9, 9)).astype(np.float32),
        np.where(rng.random((4, 9)) < 0.3, np.inf, rng.normal(size=(4, 9))).astype(np.float32),
        np.full((2, 9), np.inf, np.float32),
    ])[None]
    for k in (1, 4, 9):
        got = _topk_smallest_iter(_t(rows), k).numpy()
        want = (-torch.topk(-_t(rows), k, dim=-1).values).numpy()
        assert got.tobytes() == want.tobytes(), k
        assert got.tobytes() == np.asarray(jax.jit(j_iter, static_argnums=1)(rows, k)).tobytes(), k
    m_top = OneGNN(hidden=16, layers=1, dropout=0.0, topk=4)
    m_iter = OneGNN(hidden=16, layers=1, dropout=0.0, topk=4, topk_impl="iter")
    m_iter.load_state_dict(m_top.state_dict())
    feats = np.asarray(_row_features(jnp.asarray(rows[:, :9])))
    with torch.no_grad():
        a = m_top(_t(feats), cost=_t(rows[:, :9]))["u"].numpy()
        b = m_iter(_t(feats), cost=_t(rows[:, :9]))["u"].numpy()
    assert a.tobytes() == b.tobytes()


def test_context_tree_converts_both_ways_and_builds_from_meta(context_model):
    """A context tree maps to a state dict with ``ctx_fc1``, ``ctx_fc2``,
    ``ctx_norm`` and back bit for bit; a ``context: true`` meta builds a
    model that loads it."""
    from lapgnn_tpu_torch.train import params_to_flax

    params = context_model[0]
    sd = params_from_flax(params)
    assert {"ctx_fc1.weight", "ctx_fc2.bias", "ctx_norm.weight"} <= set(sd)
    _tree_equal(params_to_flax(sd), jax.tree_util.tree_map(np.asarray, params))
    model = build_model_from_meta({"architecture": "one_gnn", "hidden": 16, "layers": 2,
                                   "topk": 4, "context": True})
    model.load_state_dict(sd)
