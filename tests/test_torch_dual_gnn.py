"""The port's DualGNN slice against the JAX package's: ``graph_features``,
``DualGNN`` (random weights and ``artifacts/dual_gnn_r5``'s) and the DualGNN
checkpoints' weight conversion.

Same inputs, made with numpy from a seed, through both packages on the CPU.
Each test states its tolerance.  The cases batch the 8 families, so that
JAX traces one program a shape; the random DualGNN's flax apply is jitted
once in a module fixture.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapgnn_tpu.data.generators import FAMILIES
from lapgnn_tpu.models import DualGNN as FlaxDualGNN
from lapgnn_tpu.ops.features import graph_features as j_graph_features
from lapgnn_tpu_torch.models import DualGNN
from lapgnn_tpu_torch.ops.features import GraphFeatures, graph_features
from lapgnn_tpu_torch.train import (
    build_model_from_meta,
    load_checkpoint,
    params_from_flax,
    params_to_flax,
)

ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"
DUAL_CHECKPOINTS = sorted(
    str(p.parent.relative_to(ARTIFACTS)) for p in ARTIFACTS.rglob("meta.json")
    if '"dual_gnn"' in p.read_text()
)
FAMS = tuple(FAMILIES)
HIDDEN, LAYERS, HEADS = 32, 2, 4
# Channels of the edge tensor that are selections or exact arithmetic on
# them: row / column rank, gap and tie fraction, and the reduced cost.
EDGE_EXACT = (1, 2, 3, 4, 5, 6, 9)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _family_batch(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([FAMILIES[f](n, rng) for f in FAMS]).astype(np.float32)


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


@pytest.fixture(scope="module")
def j_features():
    """The JAX ``graph_features`` without and with the reduced-cost channel,
    jitted as one program (one compile a shape)."""
    return jax.jit(lambda C, u: (j_graph_features(C), j_graph_features(C, True, u)))


@pytest.mark.parametrize("include_reduced_cost", [False, True])
@pytest.mark.parametrize("n", [1, 2, 17, 64])
def test_graph_features_match_jax(n, include_reduced_cost):
    """The 8 families at n, as one batch, against the JAX function run
    eagerly (jitted, XLA turns the rank channel's division by n - 1 into a
    product with its reciprocal, one ulp apart): edge channels rank, gap,
    tie and reduced cost, and the node min and max, bit-equal; every other channel
    within 1e-5 relative to the channel's scale, max(1, max|x|) (the
    entropies of near-one-hot rows sit near 0, the positional encodings'
    sin / cos cross it; measured: entropies 3.8e-6 apart at most, std 0.09
    on the sparse family's 1e6 sentinels, a relative 1e-7)."""
    C = _family_batch(n, 100 + n)
    u = np.random.default_rng(n).normal(size=(len(FAMS), n)).astype(np.float32)
    want = j_graph_features(jnp.asarray(C), include_reduced_cost, jnp.asarray(u))
    got = graph_features(_t(C), include_reduced_cost=include_reduced_cost, u=_t(u))
    assert isinstance(got, GraphFeatures)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        for ch in range(w.shape[-1]):
            scale = max(1.0, float(np.abs(w[..., ch]).max(initial=0.0)))
            np.testing.assert_allclose(g.numpy()[..., ch], w[..., ch], rtol=0,
                                       atol=1e-5 * scale, err_msg=f"channel {ch}")
    edge_w, edge_g = np.asarray(want.edge_feat), got.edge_feat.numpy()
    for ch in EDGE_EXACT:
        np.testing.assert_array_equal(edge_g[..., ch], edge_w[..., ch], err_msg=f"channel {ch}")
    for k in (0, 1):  # node min and max
        np.testing.assert_array_equal(got.row_feat[..., k].numpy(), np.asarray(want.row_feat)[..., k])
        np.testing.assert_array_equal(got.col_feat[..., k].numpy(), np.asarray(want.col_feat)[..., k])
    if not include_reduced_cost:
        assert not edge_g[..., 9].any()


def test_graph_features_unbatched_hooks_and_ties():
    """An (n, n) input gives unbatched features equal to the batched ones;
    the sharding hooks are applied to the row and column statistics; equal
    entries (the sparse family's sentinels) rank by position, as a stable
    argsort orders them."""
    C = _family_batch(9, 3)[FAMS.index("sparse")]
    batched = graph_features(_t(C)[None])
    single = graph_features(_t(C))
    for b, s in zip(batched, single):
        np.testing.assert_array_equal(b[0].numpy(), s.numpy())
    calls = []

    def hook(x):
        calls.append(tuple(x.shape))
        return x

    hooked = graph_features(_t(C), constrain_rows=hook, constrain_cols=hook)
    assert calls == [(1, 9, 9), (1, 9, 9)]
    np.testing.assert_array_equal(hooked.edge_feat.numpy(), single.edge_feat.numpy())
    tie = np.zeros((4, 4), np.float32)
    ranks = graph_features(_t(tie)).edge_feat[..., 1].numpy()
    np.testing.assert_array_equal(ranks, np.tile(np.arange(4, dtype=np.float32) / 3, (4, 1)))


@pytest.fixture(scope="module")
def random_dual(j_features):
    """A flax DualGNN at hidden 32, 2 layers, 4 heads with random weights,
    its jitted apply, and the JAX package's features of one instance of
    each family at n = 12."""
    rng = np.random.default_rng(5)
    C = np.stack([FAMILIES[f](12, rng) for f in FAMS]).astype(np.float32)
    gf = j_features(jnp.asarray(C), jnp.zeros((len(FAMS), 12), jnp.float32))[0]
    model = FlaxDualGNN(hidden_dim=HIDDEN, layers=LAYERS, heads=HEADS, dropout=0.0)
    params = jax.jit(model.init)(jax.random.key(0), gf.edge_feat, gf.row_feat, gf.col_feat)
    params = jax.tree_util.tree_map(np.asarray, params)
    apply = jax.jit(lambda p, e, r, c, m: model.apply(p, e, r, c, m))
    return params, apply, tuple(np.asarray(x) for x in (gf.edge_feat, gf.row_feat, gf.col_feat))


def _port_dual(params, **kw):
    m = DualGNN(hidden_dim=HIDDEN, layers=LAYERS, heads=HEADS, dropout=0.0, **kw)
    m.load_state_dict(params_from_flax(params))
    return m.eval()


def _mask(masked):
    mask = np.ones((len(FAMS), 12), bool)
    if masked:
        mask[1::2, 9:] = False
    return mask


@pytest.mark.parametrize("masked", [False, True])
def test_random_dual_gnn_matches_flax(random_dual, masked):
    """Random-weight DualGNN (hidden 32, 2 layers, 4 heads) within atol
    1e-5·max(1, max|u|) of flax on every family but sparse, with and without
    a row mask (flax's LayerNorm takes E[x²]−E[x]², torch's two passes;
    products and the softmax sum in another order; measured: 6e-7 apart at
    most).  Masked entries are exactly 0.  The sparse family is held in
    ``test_random_dual_gnn_on_sparse_is_as_accurate_as_flax``."""
    params, apply, (edge, row, col) = random_dual
    mask = _mask(masked)
    want = apply(params, edge, row, col, jnp.asarray(mask) if masked else None)
    with torch.no_grad():
        got = _port_dual(params)(_t(edge), _t(row), _t(col), _t(mask) if masked else None)
    for k in ("u", "v_hint"):
        for i, fam in enumerate(FAMS):
            if fam == "sparse":
                continue
            w = np.asarray(want[k])[i]
            np.testing.assert_allclose(got[k][i].numpy(), w, rtol=0, err_msg=f"{fam} {k}",
                                       atol=1e-5 * max(1.0, float(np.abs(w).max())))
    if masked:
        assert not got["u"][1::2, 9:].any() and not got["v_hint"][1::2, 9:].any()
    else:
        np.testing.assert_allclose(got["u"].mean(-1).numpy(), 0.0, atol=1e-6)


def test_random_dual_gnn_on_sparse_is_as_accurate_as_flax(random_dual):
    """On the sparse family the scaled-cost channel reaches 1e15 (a 1e6
    sentinel over a row MAD near 1e-9), and a float32 forward keeps few
    digits: flax's own float32 result is 0.018 (u) / 0.066 (v_hint) away
    from its float64 result at max|u| 0.15.  The port in float32 is held to
    the float64 flax result within 10 times flax's float32 error (measured:
    0.077 / 0.055, 4.3 / 0.8 times)."""
    params, apply, (edge, row, col) = random_dual
    i = FAMS.index("sparse")
    want32 = apply(params, edge, row, col, None)
    p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
    want64 = apply(p64, *(x.astype(np.float64) for x in (edge, row, col)), None)
    with torch.no_grad():
        got = _port_dual(params)(_t(edge), _t(row), _t(col))
    for k in ("u", "v_hint"):
        ref = np.asarray(want64[k])[i]
        flax_err = float(np.abs(np.asarray(want32[k])[i] - ref).max())
        assert flax_err > 1e-3  # the instance is ill-conditioned in float32
        assert float(np.abs(got[k][i].numpy() - ref).max()) <= 10 * flax_err, k


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_dual_gnn_remat_gives_equal_outputs_and_gradients(random_dual, rate):
    """``remat=True`` (each layer under torch.utils.checkpoint) gives the
    same outputs and gradients as the plain model, bit for bit, also with
    dropout drawn from a caller's generator (the recomputed layer redraws
    the same masks)."""
    params, _, (edge, row, col) = random_dual
    results = []
    for remat in (False, True):
        m = _port_dual(params, remat=remat)
        m.dropout = rate
        for layer in m.layer:
            layer.dropout = rate
        gen = torch.Generator().manual_seed(11) if rate else None
        out = m(_t(edge), _t(row), _t(col), generator=gen)
        loss = (out["u"] ** 2).sum() + (out["v_hint"] ** 2).sum()
        grads = torch.autograd.grad(loss, list(m.parameters()))
        results.append((out, grads))
    (a, ga), (b, gb) = results
    for k in ("u", "v_hint"):
        np.testing.assert_array_equal(a[k].detach().numpy(), b[k].detach().numpy())
    for x, y in zip(ga, gb):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert any(float(g.abs().max()) > 0 for g in ga)


def test_dual_gnn_rejects_bad_shapes():
    """No layers, heads that do not divide the width, and an edge tensor
    that is not 4-D raise, as in flax."""
    with pytest.raises(ValueError, match="layers >= 1"):
        DualGNN(layers=0)
    with pytest.raises(ValueError, match="divisible"):
        DualGNN(hidden_dim=30, heads=4)
    with pytest.raises(ValueError, match="batch, n, n, F"):
        DualGNN(hidden_dim=8, layers=1, heads=2)(torch.zeros(3, 3, 10), torch.zeros(1, 3, 14),
                                                  torch.zeros(1, 3, 14))


def test_dual_gnn_r5_matches_flax_at_full_width(j_features):
    """The slice at full width: ``graph_features`` and
    ``artifacts/dual_gnn_r5`` (hidden 256, 6 layers, 4 heads, 3,479,090
    parameters) on a uniform and a sparse instance at n = 48, each package
    on its own features: u and v_hint within atol 1e-4·max(1, max|u|) of
    JAX (measured: u 9e-8, v_hint 1.5e-7 apart, max|v_hint| 0.07)."""
    params, meta, _ = load_checkpoint(ARTIFACTS / "dual_gnn_r5")
    assert (meta["hidden"], meta["layers"], meta["heads"]) == (256, 6, 4)
    rng = np.random.default_rng(48)
    C = np.stack([FAMILIES[f](48, rng) for f in ("uniform", "sparse")]).astype(np.float32)
    gf = j_features(jnp.asarray(C), jnp.zeros((2, 48), jnp.float32))[0]
    flax_model = FlaxDualGNN(hidden_dim=256, layers=6, heads=4, dropout=0.1)
    want = jax.jit(flax_model.apply)(params, gf.edge_feat, gf.row_feat, gf.col_feat)
    model = build_model_from_meta(meta)
    model.load_state_dict(params_from_flax(params))
    assert sum(p.numel() for p in model.parameters()) == 3_479_090
    with torch.no_grad():
        tgf = graph_features(_t(C))
        got = model.eval()(tgf.edge_feat, tgf.row_feat, tgf.col_feat)
    for k in ("u", "v_hint"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("name", DUAL_CHECKPOINTS)
def test_dual_checkpoints_load_and_round_trip(name):
    """Every DualGNN checkpoint in ``artifacts/`` builds from its meta,
    loads strictly, and ``params_to_flax(params_from_flax(t)) == t`` (keys,
    order, dtypes and bytes)."""
    params, meta, _ = load_checkpoint(ARTIFACTS / name)
    model = build_model_from_meta(meta)
    assert isinstance(model, DualGNN)
    sd = params_from_flax(params)
    model.load_state_dict(sd, strict=True)
    assert (model.hidden_dim, model.num_layers, model.heads) == (
        meta["hidden"], meta["layers"], meta["heads"])
    _tree_equal(params_to_flax(sd), params)


def test_all_ten_dual_checkpoints_are_found():
    assert len(DUAL_CHECKPOINTS) == 10, DUAL_CHECKPOINTS
