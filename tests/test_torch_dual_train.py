"""The port's DualGNN trainer against the JAX package's.

``build_dual_gnn`` (flax's leaf names, shapes and initialisers), one train
step (loss, metrics and gradients against ``jax.value_and_grad`` of the
JAX step's loss, from the same initial tree), the sparse family against
JAX's float64 result, one step at ``artifacts/dual_gnn_r5``'s full width, and
a whole ``train_dual_gnn`` run.  Same inputs, made with numpy from a seed,
through both packages on the CPU, at hidden 32, 2 layers, 4 heads unless a
test says otherwise.  Each test states its tolerance.

JAX's compiles are most of this file's time, and ``graph_features`` is most
of a compile, so the JAX features of the (2, 24) batches come from one
jitted ``graph_features`` and the JAX loss and its gradient take them as
inputs (no gradient flows into the cost), jitted once a width and
precision.  The trainers' early stop is held through both CLIs in
``test_torch_cli.py``.
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
from lapgnn_tpu.train import dual_trainer as jdt
from lapgnn_tpu.train.loss import dual_gnn_loss as j_dual_gnn_loss
from lapgnn_tpu_torch.data.synthetic import generate_synthetic_instance, instance_record
from lapgnn_tpu_torch.models import DualGNN
from lapgnn_tpu_torch.train import dual_trainer as tdt
from lapgnn_tpu_torch.train import load_checkpoint, params_from_flax, params_to_flax
from lapgnn_tpu_torch.train.schedule import make_optimizer

R5 = Path(__file__).resolve().parent.parent / "artifacts" / "dual_gnn_r5"
HIDDEN, LAYERS, HEADS = 32, 2, 4
N, B = 24, 2
FAMS = tuple(f for f in FAMILIES if f != "sparse")
METRICS = {"loss": None, "primal_gap_mean": "primal_gap", "feas_mean": "feas",
           "v_mse_mean": "v_mse"}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _labelled(fam, n, count, seed):
    rng = np.random.default_rng(seed)
    return [instance_record(generate_synthetic_instance(fam, n, rng)) for _ in range(count)]


def _batch(fam, n=N, count=B, seed=0):
    recs = _labelled(fam, n, count, 1000 + seed + 17 * list(FAMILIES).index(fam))
    return (np.stack([r["cost"] for r in recs]).astype(np.float32),
            np.stack([r["u"] for r in recs]).astype(np.float32))


_j_features = jax.jit(j_graph_features)


def _j_value_and_grad(model, dtype=jnp.float32):
    """The JAX train step's loss (``dual_trainer.make_dual_train_step`` :66)
    at dropout 0 with the trainer's defaults, and its gradient, jitted;
    ``run(params, cost, u_target)`` computes the features in float32 in
    their own jitted program, as both float32 steps see them."""
    def loss_fn(params, cost, u_target, edge, row, col):
        preds = model.apply(params, edge, row, col)
        return j_dual_gnn_loss(cost, preds, normalize_gap=True, clip_sentinels=True,
                               u_target=u_target)

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    def run(params, cost, u_target):
        gf = _j_features(jnp.asarray(cost, jnp.float32))
        cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731
        params = jax.tree_util.tree_map(cast, params)
        return vg(params, cast(cost), cast(u_target), cast(gf.edge_feat), cast(gf.row_feat),
                  cast(gf.col_feat))

    return run


def _port_model(tree, hidden=HIDDEN, layers=LAYERS, heads=HEADS):
    model = DualGNN(hidden_dim=hidden, layers=layers, heads=heads, dropout=0.0)
    model.load_state_dict(params_from_flax(tree))
    return model


def _port_grads(model, cost, ut):
    names = [k for k, _ in model.named_parameters()]
    loss, metrics, grads = tdt.dual_loss_and_grads(model, list(model.parameters()), _t(cost), _t(ut))
    return loss, metrics, params_to_flax(dict(zip(names, grads)))


def _hold_grads(got, want):
    """Each gradient leaf within 1e-4·max|g| + 1e-7, max|g| over the whole
    gradient: float32 sums in another order, forward and backward."""
    want = _flat(jax.tree_util.tree_map(np.asarray, want))
    got = _flat(got)
    assert set(got) == set(want)
    g_max = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * g_max + 1e-7, err_msg=k)


@pytest.fixture(scope="module")
def init_tree():
    """The port's initial tree at hidden 32, 2 layers, 4 heads (flax's
    initialisers, seed 11), as the flax tree both packages start from."""
    return params_to_flax(tdt.build_dual_gnn(HIDDEN, LAYERS, HEADS, 0.0, seed=11,
                                             device="cpu").state_dict())


@pytest.fixture(scope="module")
def j_step():
    return _j_value_and_grad(FlaxDualGNN(hidden_dim=HIDDEN, layers=LAYERS, heads=HEADS, dropout=0.0))


# ---------------------------------------------------------------- initialisation


@pytest.mark.parametrize("hidden,layers,heads", [(HIDDEN, LAYERS, HEADS), (256, 6, 4)])
def test_build_dual_gnn_has_flax_leaves_and_initialisers(hidden, layers, heads):
    """The tree has flax's leaf names and shapes (from ``jax.eval_shape`` of
    flax's init); the global torch RNG is untouched and one seed gives
    bit-equal trees; LayerNorms are ones and zeros, every bias and attention
    bias zero; the attention weights lie within flax's xavier limit
    sqrt(6 / (3·heads + head_dim·heads)), above torch's own
    sqrt(6 / (3·head_dim + heads·head_dim)) (at r5's width 0.1496 and
    0.1157); a Dense kernel's std is 1/sqrt(fan_in) within 5%."""
    state = torch.get_rng_state()
    got = params_to_flax(tdt.build_dual_gnn(hidden, layers, heads, 0.1, seed=5,
                                            device="cpu").state_dict())
    again = params_to_flax(tdt.build_dual_gnn(hidden, layers, heads, 0.1, seed=5,
                                              device="cpu").state_dict())
    assert torch.equal(state, torch.get_rng_state())
    n = 8
    model = FlaxDualGNN(hidden_dim=hidden, layers=layers, heads=heads)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, n, n, 10)),
                            jnp.zeros((1, n, 14)), jnp.zeros((1, n, 14)))
    want = {k: tuple(v.shape) for k, v in _flat(shapes).items()}
    flat = _flat(got)
    assert {k: v.shape for k, v in flat.items()} == want
    for k, v in flat.items():
        np.testing.assert_array_equal(v, _flat(again)[k], err_msg=k)
    head_dim = hidden // heads
    flax_limit = (6.0 / (3 * heads + head_dim * heads)) ** 0.5
    torch_limit = (6.0 / (3 * head_dim + heads * head_dim)) ** 0.5
    attn = np.concatenate([v.ravel() for k, v in flat.items() if k.endswith(("/attn_row", "/attn_col"))])
    assert attn.size == 2 * layers * heads * 3 * head_dim
    assert torch_limit < float(np.abs(attn).max()) <= flax_limit
    for k, v in flat.items():
        if k.endswith(("/bias", "_bias")):
            assert not v.any(), k
        elif k.endswith("/scale"):
            assert (v == 1).all(), k
    kernel = flat["/params/layer_0/edge_fc3/kernel"]  # (128, hidden)
    np.testing.assert_allclose(kernel.std(), 1 / np.sqrt(kernel.shape[0]), rtol=0.05)


def test_dual_layer_draws_flax_fans_without_a_generator():
    """``DualGNN(...)`` built directly draws its attention weights with
    flax's fans too (from the global RNG, as every torch module does)."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        m = DualGNN(hidden_dim=256, layers=2, heads=4)
    attn = torch.cat([p.detach().flatten() for k, p in m.named_parameters()
                      if k.endswith(("attn_row", "attn_col"))])
    assert 0.1157 < float(attn.abs().max()) <= 0.1496


# ---------------------------------------------------------------- one step


@pytest.mark.parametrize("fam", FAMS)
def test_train_step_matches_jax(fam, init_tree, j_step):
    """One step from the same tree, dropout 0, hidden 32, 2 layers, B = 2 at
    n = 24: the loss within 1e-5 relative; the step's four metrics (loss,
    mean primal gap, feasibility and v-MSE) within 1e-5 relative to
    max(|JAX's|, 1e-3) (the mean hinge sits near 0); each gradient within
    1e-4·max|g| + 1e-7.  The step moves the parameters and returns device
    tensors."""
    cost, ut = _batch(fam)
    (lj, mj), gj = j_step(init_tree, cost, ut)
    model = _port_model(init_tree)
    lt, _, gt = _port_grads(model, cost, ut)
    assert abs(float(lt.detach()) - float(lj)) <= 1e-5 * abs(float(lj))
    _hold_grads(gt, gj)

    opt = make_optimizer(list(model.parameters()), 1e-3)
    before = [p.detach().clone() for p in model.parameters()]
    m = tdt.make_dual_train_step(model, opt)(_t(cost), _t(ut))
    assert set(m) == set(METRICS)
    for k, jk in METRICS.items():
        want = float(lj) if jk is None else float(jnp.mean(mj[jk]))
        assert isinstance(m[k], torch.Tensor) and m[k].ndim == 0
        assert abs(float(m[k]) - want) <= 1e-5 * max(abs(want), 1e-3), (k, float(m[k]), want)
    assert any(not torch.equal(a, p) for a, p in zip(before, model.parameters()))


def test_train_step_on_sparse_is_as_accurate_as_jax(init_tree, j_step):
    """The sparse family's 1e6 sentinels put the features' scaled-cost
    channel near 1e15, and a float32 forward and backward keep few digits
    (``test_torch_dual_gnn.py`` shows it for the forward).  The port's
    float32 loss and gradient are held to JAX's float64 ones (model and
    loss in float64 on the float32 features) within 10 times JAX's own
    float32 error, the gradient by its largest difference over all
    leaves."""
    cost, ut = _batch("sparse")
    (l32, _), g32 = j_step(init_tree, cost, ut)
    model = FlaxDualGNN(hidden_dim=HIDDEN, layers=LAYERS, heads=HEADS, dropout=0.0)
    (l64, _), g64 = _j_value_and_grad(model, jnp.float64)(init_tree, cost, ut)
    lt, _, gt = _port_grads(_port_model(init_tree), cost, ut)
    ref = {k: np.asarray(v) for k, v in _flat(jax.tree_util.tree_map(np.asarray, g64)).items()}

    def err(tree):
        flat = _flat(jax.tree_util.tree_map(np.asarray, tree))
        return max(float(np.abs(np.asarray(flat[k], np.float64) - ref[k]).max()) for k in ref)

    j_loss_err = abs(float(l32) - float(l64))
    assert abs(float(lt.detach()) - float(l64)) <= 10 * max(j_loss_err, 1e-7 * abs(float(l64)))
    assert err(gt) <= 10 * err(g32)


def test_train_step_at_r5_full_width_matches_jax():
    """``artifacts/dual_gnn_r5`` (hidden 256, 6 layers, 4 heads), B = 2
    uniform instances at n = 24 (the step tests' shape, so that JAX's
    features compile once), dropout 0: loss within 1e-5 relative, each
    gradient within 1e-4·max|g| + 1e-7."""
    tree, meta, _ = load_checkpoint(R5)
    hidden, layers, heads = meta["hidden"], meta["layers"], meta["heads"]
    cost, ut = _batch("uniform", seed=1)
    model = FlaxDualGNN(hidden_dim=hidden, layers=layers, heads=heads, dropout=0.0)
    (lj, _), gj = _j_value_and_grad(model)(tree, cost, ut)
    lt, _, gt = _port_grads(_port_model(tree, hidden, layers, heads), cost, ut)
    assert abs(float(lt.detach()) - float(lj)) <= 1e-5 * abs(float(lj))
    _hold_grads(gt, gj)


# ---------------------------------------------------------------- whole runs


@pytest.fixture
def jax_init_by_shape(monkeypatch):
    """JAX's ``train_dual_gnn`` without its op-by-op initialisation: every
    initial value is replaced by ``init_params`` (the log says so), so the
    flax init is traced for its shapes only (``jax.eval_shape``) and the
    sample's features are not computed.  The jitted steps are JAX's own."""
    real = jdt.graph_features

    def features(cost):
        return real(cost) if isinstance(cost, jax.core.Tracer) else jax.eval_shape(real, cost)

    class ShapeInit(FlaxDualGNN):
        def init(self, key, *feats):
            shapes = jax.eval_shape(lambda k, *f: FlaxDualGNN.init(self, k, *f), key, *feats)
            return jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)

    monkeypatch.setattr(jdt, "graph_features", features)
    monkeypatch.setattr(jdt, "DualGNN", ShapeInit)


def test_train_dual_gnn_matches_jax(jax_init_by_shape):
    """2 epochs, dropout 0, hidden 16, 1 layer, 2 heads, warm-started from
    one tree, 6 train instances at n = 16 (batch 2: 3 steps an epoch) and 2
    val: the same log lines but the timings, every leaf restored, history
    values within 1e-4 relative, best params within 2e-5 (measured at
    hidden 32: 1.3e-6 apart)."""
    cfg = dict(hidden=16, layers=1, heads=2, dropout=0.0, epochs=2, batch_size=2,
               min_epochs=1, patience=4, seed=3)
    train = _labelled("uniform", 16, 3, 0) + _labelled("noisy_linear", 16, 3, 1)
    val = _labelled("block", 16, 2, 2)
    init = params_to_flax(tdt.build_dual_gnn(16, 1, 2, 0.0, seed=9, device="cpu").state_dict())
    jlog, tlog = [], []
    jbest, jhist = jdt.train_dual_gnn(train, val, jdt.DualTrainConfig(**cfg), log_fn=jlog.append,
                                      init_params=init)
    tbest, thist = tdt.train_dual_gnn(train, val, tdt.DualTrainConfig(**cfg), log_fn=tlog.append,
                                      init_params=init, device="cpu")
    strip = [s.rsplit(" (", 1)[0] for s in jlog], [s.rsplit(" (", 1)[0] for s in tlog]
    assert tlog[0] == jlog[0] == "warm init: 34/34 param leaves from checkpoint"
    assert strip[0] == strip[1]
    assert {k: len(v) for k, v in thist.items()} == {k: len(v) for k, v in jhist.items()}
    for k in jhist:
        np.testing.assert_allclose(thist[k], jhist[k], rtol=1e-4, err_msg=k)
    want = _flat(jax.tree_util.tree_map(np.asarray, jbest))
    got = _flat(tbest)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-5, err_msg=k)


def test_train_dual_gnn_takes_no_mesh_and_leaves_the_global_rng():
    """``mesh=`` takes only a ('row', 'col') mesh (``parallel.dual_mesh``;
    training under one is held in ``test_torch_parallel_train.py``) and
    raises on any other; with dropout on, two CPU runs from one seed end
    bit-equal without touching the global torch RNG; without validation the
    latest params are returned."""
    from types import SimpleNamespace

    train = _labelled("uniform", 8, 2, 4)
    cfg = tdt.DualTrainConfig(hidden=8, layers=1, heads=2, dropout=0.3, epochs=1, batch_size=2)
    with pytest.raises(ValueError, match="'row', 'col'"):
        tdt.train_dual_gnn(train, None, cfg, mesh=SimpleNamespace(axis_names=("data", "model")),
                           device="cpu")
    state = torch.get_rng_state()
    runs = [tdt.train_dual_gnn(train, None, cfg, log_fn=lambda s: None, device="cpu")
            for _ in range(2)]
    assert torch.equal(state, torch.get_rng_state())
    a, b = _flat(runs[0][0]), _flat(runs[1][0])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert runs[0][1] == runs[1][1] and runs[0][1]["val_gap_median"] == []
