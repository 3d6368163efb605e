"""The port's training slice against the JAX package's.

Loss, greedy bound, gradients, schedule, optimizer, model dropout and
checkpoints of ``lapgnn_tpu_torch.train`` held against ``lapgnn_tpu.train`` on
the same inputs, made with numpy from a seed, on the CPU, at a small width
(hidden 32, 2 layers, top-k 4, n in {1, 7, 16, 24, 33, 64}).  Each test
states its tolerance.  The ``cuda`` test holds the greedy kernel to its plain
version on the card and skips without one.  The trainers are in
``test_torch_trainer.py``.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from lapgnn_tpu.data.generators import FAMILIES
from lapgnn_tpu.models import OneGNN as FlaxOneGNN
from lapgnn_tpu.ops.features import row_features as j_row_features
from lapgnn_tpu.train import checkpoint as jckpt
from lapgnn_tpu.train import loss as jl
from lapgnn_tpu.train import schedule as jsched
from lapgnn_tpu.train import trainer as jtrainer
from lapgnn_tpu_torch import tracing
from lapgnn_tpu_torch.models import OneGNN
from lapgnn_tpu_torch.models.one_gnn import dropout
from lapgnn_tpu_torch.ops.cuda import greedy_total
from lapgnn_tpu_torch.ops.cuda.greedy import greedy_total_plain
from lapgnn_tpu_torch.train import checkpoint as tckpt
from lapgnn_tpu_torch.train import loss as tl
from lapgnn_tpu_torch.train import schedule as tsched
from lapgnn_tpu_torch.train import trainer as ttrainer
from lapgnn_tpu_torch.train.convert import params_from_flax, params_to_flax

HIDDEN, LAYERS, TOPK = 32, 2, 4
GREEDY_FAMS = ["uniform", "tie", "sparse", "noisy_linear", "metric"]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _costs(fam, n, B=3, seed=0):
    return np.stack(
        [FAMILIES[fam](n, np.random.default_rng(seed + b)).astype(np.float32) for b in range(B)]
    )


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _mask(B, n):
    m = np.ones((B, n), bool)
    m[1 % B, n // 2 :] = False
    m[2 % B, ::3] = False
    return m


_features = jax.jit(j_row_features)
# The JAX bound under jit, as the JAX train step runs it: one compile a shape.
_j_greedy = jax.jit(jl.greedy_primal_upper)


@functools.lru_cache(maxsize=None)
def _flax_init(n, refine, seed):
    model = FlaxOneGNN(hidden=HIDDEN, layers=LAYERS, dropout=0.0, topk=TOPK)
    cost = jnp.asarray(_costs("uniform", n, B=1, seed=seed))
    init = jax.jit(lambda key, f, c: model.init(key, f, cost=c)) if refine else jax.jit(model.init)
    args = (jax.random.key(seed), _features(cost)) + ((cost,) if refine else ())
    return model, jax.tree_util.tree_map(np.asarray, init(*args))


def _flax_params(n, refine=True, seed=0):
    """The flax model and a fresh copy of its initial tree (numpy leaves)."""
    model, tree = _flax_init(n, refine, seed)
    return model, jax.tree_util.tree_map(np.copy, tree)


def _assert_tree_close(got, want, rtol, atol, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _assert_tree_close(got[k], want[k], rtol, atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=path)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# ---------------------------------------------------------------- the greedy bound


def _reduced(C, seed):
    u = np.random.default_rng(seed).normal(size=C.shape[:2]).astype(np.float32) * 0.3
    v = np.asarray(jl.masked_v_proj(jnp.asarray(C), jnp.asarray(u), None))
    return C - u[..., None] - v[:, None, :]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [1, 7, 33, 64])
@pytest.mark.parametrize("fam", GREEDY_FAMS)
def test_greedy_primal_upper_bit_equal(fam, n, masked):
    """Bit-equal to the JAX scan: same visiting order (stable argsort), same
    argmin ties, the float32 sum in visiting order."""
    C = _costs(fam, n)
    red = _reduced(C, n)
    m = _mask(3, n) if masked else None
    want = _j_greedy(jnp.asarray(C), jnp.asarray(red), None if m is None else jnp.asarray(m))
    got = tl.greedy_primal_upper(_t(C), _t(red), None if m is None else _t(m))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_greedy_primal_upper_special_values():
    """+inf entries (a row whose unused entries are all +inf takes the first
    +inf column, used or not), all-equal rows, -0.0 and +0.0, a NaN."""
    n = 12
    C = _costs("uniform", n)
    red = _reduced(C, 1)
    red[0, 3, :] = np.inf
    red[0, 5, 2:] = np.inf
    red[1] = 0.5
    red[1, ::2, ::2] = -0.0
    red[2, 4, 7] = np.nan
    for m in (None, _mask(3, n)):
        want = jl.greedy_primal_upper(jnp.asarray(C), jnp.asarray(red), None if m is None else jnp.asarray(m))
        got = tl.greedy_primal_upper(_t(C), _t(red), None if m is None else _t(m))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_greedy_takes_no_gradient_and_cpu_counts_no_launch():
    C = _t(_costs("uniform", 16))
    u = torch.zeros((3, 16), requires_grad=True)
    red = C - u[..., None]
    before = tracing.counters()
    out = tl.greedy_primal_upper(C, red)
    assert not out.requires_grad
    assert tracing.counters().get("launch.greedy_total", 0) == before.get("launch.greedy_total", 0)


def test_greedy_wrapper_validates_inputs():
    C = _t(_costs("uniform", 8))
    order = torch.argsort(C.amin(-1), dim=-1, stable=True)
    with pytest.raises(ValueError):
        greedy_total(C.to("meta"), C.to("meta"), order.to("meta"))
    from lapgnn_tpu_torch.ops.cuda.greedy import greedy_total_kernel

    with pytest.raises(ValueError):
        greedy_total_kernel(C, C, order)  # a CPU tensor never reaches the kernel
    assert torch.equal(greedy_total(C, C, order), greedy_total_plain(C, C, order))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 512, 1024, 2048, 4097])
def test_greedy_kernel_equals_plain_on_card(cuda, n):
    B = 2 if n > 2048 else 4
    C = torch.from_numpy(_costs("tie", n, B=B)).to(cuda)
    red = C - C.amin(-2, keepdim=True)
    red[0, 0, :] = torch.inf
    red[B - 1, n // 2, (n - 1) // 3 :: 5] = torch.nan  # the first NaN wins the argmin
    order = torch.argsort(red.amin(-1), dim=-1, stable=True)
    valid = torch.ones((B, n), dtype=torch.bool, device=cuda)
    valid[1, ::2] = False
    for v in (None, valid):
        got = greedy_total(red, C, order, v)
        want = greedy_total_plain(red, C, order, v)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------- the losses


@pytest.mark.parametrize("masked", [False, True])
def test_masked_v_proj_matches_jax(masked):
    C = _costs("sparse", 24)
    u = np.random.default_rng(2).normal(size=(3, 24)).astype(np.float32)
    m = _mask(3, 24) if masked else None
    want = jl.masked_v_proj(jnp.asarray(C), jnp.asarray(u), None if m is None else jnp.asarray(m))
    got = tl.masked_v_proj(_t(C), _t(u), None if m is None else _t(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("include_primal", [True, False])
@pytest.mark.parametrize("normalize_gap", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_one_gnn_loss_matches_jax(masked, normalize_gap, include_primal):
    """Loss within 1e-5 relative and each metric within 1e-5 relative + 1e-6
    (float32 sums over n^2 entries in another order)."""
    C = _costs("noisy_linear", 33)
    rng = np.random.default_rng(3)
    u = rng.normal(size=(3, 33)).astype(np.float32)
    ut = u + 0.1 * rng.normal(size=(3, 33)).astype(np.float32)
    m = _mask(3, 33) if masked else None
    kw = dict(normalize_gap=normalize_gap, include_primal=include_primal)
    lj, mj = jl.one_gnn_loss(jnp.asarray(C), jnp.asarray(ut), {"u": jnp.asarray(u)},
                             mask=None if m is None else jnp.asarray(m), **kw)
    lt, mt = tl.one_gnn_loss(_t(C), _t(ut), {"u": _t(u)}, mask=None if m is None else _t(m), **kw)
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    for k in ("primal_gap", "feas", "u_mse", "v_proj"):
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("with_u_target", [False, True])
@pytest.mark.parametrize("clip_sentinels", [False, True])
def test_dual_gnn_loss_matches_jax(clip_sentinels, with_u_target):
    C = _costs("sparse", 24)
    rng = np.random.default_rng(4)
    preds = {"u": rng.normal(size=(3, 24)).astype(np.float32),
             "v_hint": rng.normal(size=(3, 24)).astype(np.float32)}
    ut = rng.normal(size=(3, 24)).astype(np.float32) if with_u_target else None
    m = _mask(3, 24)
    lj, mj = jl.dual_gnn_loss(jnp.asarray(C), {k: jnp.asarray(v) for k, v in preds.items()},
                              mask=jnp.asarray(m), normalize_gap=True, clip_sentinels=clip_sentinels,
                              u_target=None if ut is None else jnp.asarray(ut))
    lt, mt = tl.dual_gnn_loss(_t(C), {k: _t(v) for k, v in preds.items()}, mask=_t(m),
                              normalize_gap=True, clip_sentinels=clip_sentinels,
                              u_target=None if ut is None else _t(ut))
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def _jax_loss_fn(model, use_cost, normalize_gap, normalize_costs):
    def loss_fn(params, cost, ut):
        if normalize_costs:
            cost, ut = jtrainer._normalize_instance(cost, ut)
        preds = model.apply(params, j_row_features(cost), cost=cost if use_cost else None)  # jitted by the caller
        return jl.one_gnn_loss(cost, ut, preds, normalize_gap=normalize_gap)[0]

    return loss_fn


def _grad_tree(model, grads, refine):
    named = [n for n, _ in model.named_parameters()
             if refine or not n.startswith(("edge_mlp.", "message_norm."))]
    return params_to_flax(dict(zip(named, grads)), refine=refine)


@pytest.mark.parametrize(
    "use_cost,normalize_costs,normalize_gap",
    [(True, True, True), (True, False, False), (False, True, False), (False, False, True)],
)
def test_one_gnn_loss_gradients_match_jax(use_cost, normalize_costs, normalize_gap):
    """Gradients of the OneGNN loss through the port's model against jax.grad
    through the flax model, from the same parameters, with and without the
    cost refinement and each normalisation on and off: each leaf within
    1e-4 * max|g| + 1e-7, max|g| over the whole gradient (float32 sums in
    another order, forward and backward; a leaf whose exact gradient is zero,
    the head's last bias, which the gauge centring cancels, holds rounding
    only)."""
    n = 24
    fmodel, params = _flax_params(n, refine=use_cost, seed=1)
    C = _costs("uniform", n, B=4, seed=7) * 3.0 + 0.5
    ut = np.random.default_rng(5).normal(size=(4, n)).astype(np.float32)
    value_and_grad = jax.jit(jax.value_and_grad(_jax_loss_fn(fmodel, use_cost, normalize_gap, normalize_costs)))
    lj, gj = value_and_grad(params, jnp.asarray(C), jnp.asarray(ut))

    model = OneGNN(hidden=HIDDEN, layers=LAYERS, dropout=0.0, topk=TOPK)
    ttrainer.load_params(model, params)
    plist = ttrainer.trainable_parameters(model, use_cost)
    lt, _, gt = ttrainer.loss_and_grads(model, plist, _t(C), _t(ut), use_cost,
                                        normalize_gap=normalize_gap, normalize_costs=normalize_costs)
    assert abs(float(lt.detach()) - float(lj)) <= 1e-5 * abs(float(lj))
    want = jax.tree_util.tree_map(np.asarray, gj)
    g_max = max(float(np.abs(w).max()) for w in jax.tree_util.tree_leaves(want))
    _assert_tree_close(_grad_tree(model, gt, use_cost), want, 0, 1e-4 * g_max + 1e-7)


def test_min_trick_gradient_splits_ties_like_jax():
    """Two rows tie for a column's minimum: the gradient splits evenly."""
    C = np.array([[[1.0, 2.0], [1.0, 3.0]]], np.float32)
    u0 = np.zeros((1, 2), np.float32)
    gj = jax.grad(lambda u: jl.masked_v_proj(jnp.asarray(C), u, None).sum())(jnp.asarray(u0))
    u = _t(u0).requires_grad_()
    tl.masked_v_proj(_t(C), u, None).sum().backward()
    np.testing.assert_array_equal(u.grad.numpy(), np.asarray(gj))


# ---------------------------------------------------------------- schedule and optimizer


@pytest.mark.parametrize("min_lr", [0.0, 1e-5])
@pytest.mark.parametrize("warmup,total", [(0, 7), (3, 40), (10, 10)])
def test_warmup_cosine_matches_optax(warmup, total, min_lr):
    """Every step of the run and past its end, within 1e-6 relative (optax
    computes in float32 or float64, the port in Python floats)."""
    want = jsched.warmup_cosine(2e-4, warmup, total, min_lr)
    got = tsched.warmup_cosine(2e-4, warmup, total, min_lr)
    assert got(0) == 0.0
    for step in range(total + 3):
        w = float(want(jnp.asarray(step, jnp.int32)))
        assert abs(got(step) - w) <= 1e-6 * abs(w) + 1e-12, (step, got(step), w)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_optimizer_matches_optax(grad_scale):
    """5 steps of optax's clip_by_global_norm + adamw fed identical
    gradients: params within 1e-6 relative + 1e-8.  ``grad_scale`` 10 makes
    the global norm exceed the clip, 1e-3 keeps it below."""
    rng = np.random.default_rng(6)
    shapes = {"a": (4, 3), "b": (3,), "c": (2, 2)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (grad_scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    sched = jsched.warmup_cosine(1e-2, 2, 5, 1e-3)
    tx = jsched.make_optimizer(sched, 1e-4, 1.0)
    pj = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(pj)
    tparams = [_t(p0[k]) for k in shapes]
    opt = tsched.make_optimizer(tparams, tsched.warmup_cosine(1e-2, 2, 5, 1e-3), 1e-4, 1.0)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, pj)
        pj = optax.apply_updates(pj, upd)
        opt.step([_t(g[k]) for k in shapes])
    for k, t in zip(shapes, tparams):
        np.testing.assert_allclose(t.numpy(), np.asarray(pj[k]), rtol=1e-6, atol=1e-8, err_msg=k)
    # step 0 runs at lr 0 in both: a first step leaves the params
    fresh = [_t(p0[k]) for k in shapes]
    tsched.make_optimizer(fresh, tsched.warmup_cosine(1e-2, 2, 5), 1e-4, 1.0).step(
        [_t(grads[0][k]) for k in shapes])
    assert all(torch.equal(f, _t(p0[k])) for f, k in zip(fresh, shapes))


def test_optimizer_state_roundtrip():
    params = [torch.ones(3), torch.zeros(2, 2)]
    opt = tsched.AdamW(params, 1e-2)
    opt.step([torch.ones(3), torch.ones(2, 2)])
    state = opt.state_dict()
    other = tsched.AdamW([p.clone() for p in params], 1e-2)
    other.load_state_dict(state)
    opt.step([torch.ones(3), torch.ones(2, 2)])
    other.step([torch.ones(3), torch.ones(2, 2)])
    assert other.count == opt.count == 2
    assert all(torch.equal(a, b) for a, b in zip(opt.params, other.params))


# ---------------------------------------------------------------- model and checkpoints


def test_dropout_uses_only_the_callers_generator():
    x = torch.ones(2000)
    state = torch.get_rng_state()
    assert dropout(x, 0.25, None) is x
    assert dropout(x, 0.0, torch.Generator().manual_seed(0)) is x
    y1 = dropout(x, 0.25, torch.Generator().manual_seed(3))
    y2 = dropout(x, 0.25, torch.Generator().manual_seed(3))
    assert torch.equal(y1, y2)
    kept = y1 != 0
    assert 0.7 < kept.float().mean() < 0.8
    assert torch.equal(y1[kept], torch.full_like(y1[kept], 1 / 0.75))
    assert torch.equal(dropout(x, 1.0, torch.Generator()), torch.zeros_like(x))
    assert torch.equal(state, torch.get_rng_state())


def test_model_dropout_only_with_a_generator():
    model = ttrainer.build_one_gnn(HIDDEN, LAYERS, 0.3, TOPK, seed=2, device="cpu")
    C = _t(_costs("uniform", 16, B=2))
    feats = _t(_features(jnp.asarray(C.numpy())))
    base = model(feats, cost=C)["u"]
    model.train()
    assert torch.equal(model(feats, cost=C)["u"], base)  # no generator: no dropout
    a = model(feats, cost=C, generator=torch.Generator().manual_seed(1))["u"]
    b = model(feats, cost=C, generator=torch.Generator().manual_seed(1))["u"]
    assert torch.equal(a, b) and not torch.equal(a, base)


def test_params_to_flax_inverts_params_from_flax():
    tree, _, _ = tckpt.load_checkpoint("artifacts/one_gnn_default")
    back = params_to_flax(params_from_flax(tree))
    assert tckpt.msgpack_serialize(back) == (
        open("artifacts/one_gnn_default/params.msgpack", "rb").read())
    _, small = _flax_params(16, refine=False)
    back = params_to_flax(params_from_flax(small), refine=False)
    _assert_tree_close(back, small, 0, 0)


def test_msgpack_writer_is_byte_equal_to_flax():
    tree = {
        "z": np.arange(300, dtype=np.int64).reshape(3, 100),
        "b": {"c": np.float32(3.5), "d": np.zeros((0,), np.float16),
              "e": np.ones((70000,), np.uint8), "a": np.bool_(True)},
        "k" * 40: np.array(5.0),
        **{f"m{i}": np.ones(i + 1, np.float32) for i in range(20)},
    }
    assert tckpt.msgpack_serialize(tree) == serialization.msgpack_serialize(dict(tree))


def test_merge_params_matches_jax():
    _, fresh = _flax_params(16, refine=True, seed=0)
    _, loaded = _flax_params(16, refine=False, seed=1)
    loaded["params"]["head_fc2"]["kernel"] = np.zeros((3, 1), np.float32)  # wrong shape
    jm, jl_, jt = jckpt.merge_params(fresh, loaded)
    tm, tl_, tt = tckpt.merge_params(fresh, loaded)
    assert (tl_, tt) == (jl_, jt) and jl_ < jt
    _assert_tree_close(tm, jax.tree_util.tree_map(np.asarray, jm), 0, 0)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port's params.msgpack restores in flax to the same tree, and JAX's
    load_checkpoint + build_model_from_meta give the port's forward (within
    1e-5 relative + 1e-5: float32 sums in another order)."""
    model = ttrainer.build_one_gnn(HIDDEN, LAYERS, 0.0, TOPK, seed=4, device="cpu")
    tree = ttrainer.model_params(model, True)
    meta = {"architecture": "one_gnn", "hidden": HIDDEN, "layers": LAYERS, "dropout": 0.0,
            "topk": TOPK, "context": False, "use_cost_refinement": True, "row_feat_dim": 21}
    opt = tsched.AdamW(ttrainer.trainable_parameters(model, True), 1e-3)
    tckpt.save_checkpoint(tmp_path, tree, meta, opt_state=opt.state_dict())
    raw = (tmp_path / "params.msgpack").read_bytes()
    _assert_tree_close(serialization.msgpack_restore(raw), tree, 0, 0)
    jparams, jmeta, _ = jckpt.load_checkpoint(tmp_path)
    jmodel = jckpt.build_model_from_meta(jmeta)
    C = _costs("uniform", 20, B=2)
    feats = np.asarray(_features(jnp.asarray(C)))
    want = jax.jit(lambda p, f, c: jmodel.apply(p, f, cost=c))(jparams, feats, jnp.asarray(C))["u"]
    with torch.no_grad():
        got = model(_t(feats), cost=_t(C))["u"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    params, meta2, state = tckpt.load_checkpoint(tmp_path, with_opt_state=True)
    assert meta2 == json.loads((tmp_path / "meta.json").read_text()) and state["count"] == 0
