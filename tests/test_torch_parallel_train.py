"""The port's training under a mesh (``lapgnn_tpu_torch.parallel``) on the CPU.

World sizes 2 and 4 each run once, as gloo ranks in spawned processes
(``parallel.launch.spawn_ranks``, a file rendezvous, a 60 s timeout on every
collective); every check of that world size runs inside them and the ranks
write what they computed to files that the tests read.  The pytest process
never joins a process group: it makes the inputs with numpy from fixed
seeds, computes the references (the port's unsharded steps, JAX's
single-device ones) while the ranks run, and compares.

  * The gradient-carrying collectives (``all_reduce_sum``,
    ``all_reduce_min`` / ``all_reduce_max``, ``reduce_min``, ``all_gather``,
    ``pvary``): each rank's input gradient equals the unsharded op's
    gradient of the same block (ties split as ``torch.amin`` splits them),
    exactly; ``torch.autograd.gradcheck`` in float64 of each op fed a
    replicated input through ``pvary``.
  * ``make_dp_train_step`` (OneGNN hidden 16, 1 layer, top-k 16, dropout 0,
    n = 16, batch 8) at data 2 x model 1, 1 x 2, 2 x 2 and on
    ``make_hierarchical_mesh``: the loss within rtol 1e-4 of JAX's
    single-device ``make_train_step`` (the JAX test's tolerance) and within
    1e-5 of the port's unsharded step; gradients within 1e-4 max|g| + 1e-7
    of the port's unsharded ones; updated parameters bit-equal across ranks
    and within 1e-4 max|dp| + 1e-7 of the unsharded update (``_close_update``
    says where the first AdamW step turns rounding into a whole step); the
    only collectives larger than a vector of the batch are the greedy
    bound's two row gathers and the parameter-gradient all-reduces.
  * ``make_sharded_dual_predict`` (DualGNN hidden 16, 2 layers, 2 heads,
    n = 32, batch 2) on 2 x 1, 1 x 2 and 2 x 2 meshes: u and v within
    atol 1e-5 of JAX's single-device forward and ``min_trick_v``, both
    ``project`` modes (the JAX test's tolerance).
  * ``make_sharded_dual_train_step`` on the same meshes: the loss within
    atol 1e-5 of JAX's replicated step, gradients within 1e-4 max|g| + 1e-7
    of ``jax.grad``, updated parameters within atol 1e-5 of JAX's (as
    ``_close_update``), bit-equal across ranks; with ``remat=True`` the same
    gradients and the same collectives in the same order on every rank.
  * ``assert_no_edge_tensor_gather`` passes on the dual steps' logs at
    n = 256 (predict and train, forward and backward) and fails on a planted
    gather of the edge features; ``dual_mesh``'s factorisations and errors.
  * ``train_dual_gnn(mesh=)`` for 2 epochs at n = 16: the history equal on
    every rank and within 1e-4 relative of JAX's ``train_dual_gnn`` over its
    4 x 2 mesh from the same initial tree; ``cli.train_dual_gnn --mesh-2d``
    under two ranks, only rank 0 writing the checkpoint.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from lapgnn_tpu_torch.data.generators import FAMILIES
from lapgnn_tpu_torch.parallel.launch import spawn_ranks

from test_torch_dual_train import jax_init_by_shape  # noqa: F401  (a fixture)

WORLDS = (2, 4)
DP_N, DP_B, DP_HIDDEN = 16, 8, 16
DUAL_N, DUAL_B, DUAL_HIDDEN, DUAL_LAYERS, DUAL_HEADS = 32, 2, 16, 2, 2
EDGE_N = 256
LR = 1e-3
# OneGNN centres u, so its head's last bias has a gradient of 0: both steps
# compute rounding there, held to one AdamW step, not compared
GAUGE_FREE = "row_out.3.bias"
DP_MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
DUAL_MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}


def _dp_step_on(mesh, inp, shard_rows=True):
    from lapgnn_tpu_torch.models import OneGNN
    from lapgnn_tpu_torch.parallel import NamedSharding, P, batch_sharding, make_dp_train_step
    from lapgnn_tpu_torch.train.schedule import make_optimizer

    model = OneGNN(hidden=DP_HIDDEN, layers=1, dropout=0.0)
    model.load_state_dict(inp["dp_state"])
    opt = make_optimizer(list(model.parameters()), LR)
    seen = []
    real = opt.step
    opt.step = lambda g: (seen.append([x.clone() for x in g]), real(g))
    mesh.log.clear()
    cost = batch_sharding(mesh, shard_n=shard_rows).local(inp["dp_cost"])
    u = NamedSharding(mesh, P("data", "model" if shard_rows else None)).local(inp["dp_u"])
    m = make_dp_train_step(model, opt, mesh, use_cost=True, shard_rows=shard_rows)(cost, u)
    return {"metrics": {k: float(v) for k, v in m.items()}, "grads": seen[0],
            "params": [p.detach().clone() for p in opt.params], "log": list(mesh.log),
            "block": tuple(cost.shape)}


def _dual_model(state, remat=False):
    from lapgnn_tpu_torch.models import DualGNN

    layers = len({k.split(".")[1] for k in state if k.startswith("layer.")})
    model = DualGNN(DUAL_HIDDEN, layers, DUAL_HEADS, dropout=0.0, remat=remat)
    model.load_state_dict(state)
    return model


def _dual_step_on(mesh, state, cost, u, remat=False):
    from lapgnn_tpu_torch.parallel.dual import local_tile, make_sharded_dual_train_step
    from lapgnn_tpu_torch.train.schedule import make_optimizer

    model = _dual_model(state, remat)
    names = [n for n, _ in model.named_parameters()]
    opt = make_optimizer(list(model.parameters()), LR)
    seen = []
    real = opt.step
    opt.step = lambda g: (seen.append([x.clone() for x in g]), real(g))
    tile = local_tile(cost, mesh)
    rows = tile.shape[-2]
    first = mesh.coordinate("row") * rows
    mesh.log.clear()
    m = make_sharded_dual_train_step(model, opt, mesh)(tile, u[:, first:first + rows])
    return {"metrics": {k: float(v) for k, v in m.items()}, "grads": dict(zip(names, seen[0])),
            "params": {n: p.detach().clone() for n, p in zip(names, opt.params)},
            "log": list(mesh.log)}


def _collective_checks(rank, world, c):
    """Each op on this rank's block, its input gradient; and gradcheck."""
    import torch.distributed as dist

    from lapgnn_tpu_torch.parallel.collectives import (
        all_gather, all_reduce_max, all_reduce_min, all_reduce_sum, pvary, reduce_min,
    )

    out = {}

    def grad_of(fn, x, w):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        (g,) = torch.autograd.grad((y * y * w).sum(), x)
        return y.detach(), g

    out["sum"] = grad_of(lambda x: all_reduce_sum(x), c["x"][rank], c["w"])
    out["min"] = grad_of(lambda x: all_reduce_min(x), c["ties"][rank], c["w"])
    out["max"] = grad_of(lambda x: all_reduce_max(x), c["ties"][rank], c["w"])
    rows = c["table"].shape[0] // world
    block = c["table"][rank * rows:(rank + 1) * rows]
    out["reduce_min"] = grad_of(lambda x: reduce_min(x, -2), block, c["w"])
    out["all_gather"] = grad_of(lambda x: all_gather(x, dim=-1), c["x"][rank], c["wide"])
    v = c["v"].clone().requires_grad_(True)
    total = all_reduce_sum((pvary(v) * c["x"][rank]).sum())
    (gv,) = torch.autograd.grad(total * total, v)
    out["pvary"] = (total.detach(), gv)

    # gradcheck: a replicated float64 input through pvary into each op, so
    # that the finite differences every rank takes alike see the whole sum
    scale = torch.arange(1, 6, dtype=torch.float64) * (rank + 1)
    shift = torch.arange(5, dtype=torch.float64) * 0.37 * (rank + 1)
    ops = {
        "sum": lambda x: all_reduce_sum(pvary(x) * scale),
        "min": lambda x: all_reduce_min(pvary(x) * scale + shift),
        "max": lambda x: all_reduce_max(pvary(x) * scale - shift),
        "reduce_min": lambda x: reduce_min((pvary(x) * scale + shift).reshape(1, 5) + shift[:, None], -2),
        "all_gather": lambda x: all_gather(pvary(x) * scale, dim=0),
    }
    x0 = torch.linspace(0.3, 1.7, 5, dtype=torch.float64, requires_grad=True)
    out["gradcheck"] = {k: torch.autograd.gradcheck(f, (x0,)) for k, f in ops.items()}
    dist.barrier()
    return out


def _rank_checks(rank, world, in_path, out_dir):
    torch.set_num_threads(1)
    from lapgnn_tpu_torch.ops.features import graph_features
    from lapgnn_tpu_torch.parallel import (
        assert_no_edge_tensor_gather, dual_mesh, make_hierarchical_mesh, make_mesh,
        make_sharded_dual_predict,
    )
    from lapgnn_tpu_torch.parallel.collectives import all_gather
    from lapgnn_tpu_torch.parallel.dual import local_tile
    from lapgnn_tpu_torch.train.dual_trainer import DualTrainConfig, train_dual_gnn

    inp = torch.load(in_path, weights_only=False)
    res = {"collectives": _collective_checks(rank, world, inp["coll"][world])}

    res["dp"] = {}
    for data, model in DP_MESHES[world]:
        mesh = make_mesh(data, model, device="cpu", timeout=60)
        res["dp"][f"{data}x{model}"] = _dp_step_on(mesh, inp)
    res["dp"]["rows_whole"] = _dp_step_on(make_mesh(world, 1, device="cpu", timeout=60), inp, False)
    if world == 4:
        hmesh = make_hierarchical_mesh(model=2, devices_per_host=2, device="cpu", timeout=60)
        res["dp"]["hierarchical"] = _dp_step_on(hmesh, inp)

    res["dual"], res["dual_predict"] = {}, {}
    for row, col in DUAL_MESHES[world]:
        mesh = dual_mesh(row, col, device="cpu", timeout=60)
        tile = local_tile(inp["dual_cost"], mesh)
        model = _dual_model(inp["dual_state"])
        res["dual_predict"][f"{row}x{col}"] = {
            project: make_sharded_dual_predict(model, mesh, project=project)(tile)
            for project in (True, False)}
        res["dual"][f"{row}x{col}"] = _dual_step_on(mesh, inp["dual_state"], inp["dual_cost"],
                                                    inp["dual_u"])
    if world == 4:
        mesh = dual_mesh(device="cpu", timeout=60)
        res["dual_remat"] = _dual_step_on(mesh, inp["dual_state"], inp["dual_cost"],
                                          inp["dual_u"], remat=True)
        # the edge-tensor contract at n = EDGE_N, forward and backward, on
        # the first layer of the model
        small = {k: v for k, v in inp["dual_state"].items() if not k.startswith("layer.1.")}
        step = _dual_step_on(mesh, small, inp["edge_cost"], inp["edge_u"])
        tile = local_tile(inp["edge_cost"], mesh)
        mesh.log.clear()
        make_sharded_dual_predict(_dual_model(small), mesh)(tile)
        res["edge_logs"] = {"train": step["log"], "predict": list(mesh.log)}
        for log in res["edge_logs"].values():
            assert_no_edge_tensor_gather(log, EDGE_N)
        mesh.log.clear()
        gf = graph_features(tile, constrain_rows=lambda t: t, constrain_cols=lambda t: t)
        all_gather(gf.edge_feat, None, mesh.log)
        try:
            assert_no_edge_tensor_gather(mesh.log, EDGE_N)
            res["planted_gather_caught"] = False
        except AssertionError as exc:
            res["planted_gather_caught"] = str(exc)

    shapes = {"auto": dual_mesh(device="cpu").shape}
    for kw in ({"row": world}, {"col": world}, {"col": 1}):
        shapes[str(sorted(kw.items()))] = dual_mesh(device="cpu", **kw).shape
    res["dual_mesh_shapes"] = shapes
    errors = {}
    for kw in ({"row": 3, "col": 3}, {"row": 3}, {"col": 3}):
        try:
            dual_mesh(device="cpu", **kw)
        except ValueError as exc:
            errors[str(sorted(kw.items()))] = str(exc)
    res["dual_mesh_errors"] = errors

    mesh = dual_mesh(device="cpu", timeout=60)
    logs = []
    cfg = DualTrainConfig(hidden=16, layers=1, heads=2, epochs=2, batch_size=2, dropout=0.0,
                          min_epochs=1)
    params, history = train_dual_gnn(inp["train"], inp["train"][:2], cfg, log_fn=logs.append,
                                     mesh=mesh, init_params=inp["train_init"])
    res["train"] = {"history": history, "logs": logs, "params": params}
    if world == 2:
        from lapgnn_tpu_torch.cli import train_dual_gnn as cli

        cli.main(["--train", inp["h5"], "--val", inp["h5"], "--epochs", "1", "--batch-size", "2",
                  "--hidden", "16", "--layers", "1", "--heads", "2", "--dropout", "0",
                  "--mesh-2d", "1x2", "--device", "cpu", "--output", f"{out_dir}/ckpt{rank}"])
    torch.save(res, f"{out_dir}/rank{rank}.pt")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _costs(n, count, seed, fams=("uniform", "block")):
    rng = np.random.default_rng(seed)
    return np.stack([FAMILIES[fams[k % len(fams)]](n, rng) for k in range(count)]).astype(np.float32)


def _collective_inputs(world, seed):
    rng = np.random.default_rng(seed)
    ties = rng.integers(0, 3, (world, 4, 5)).astype(np.float32)  # many ties across ranks
    table = rng.integers(0, 4, (world * 3, 5)).astype(np.float32)  # ties within and across blocks
    return {"x": _t(rng.normal(0, 1, (world, 4, 5))), "ties": _t(ties), "table": _t(table),
            "w": _t(rng.normal(0, 1, (4, 5))), "wide": _t(rng.normal(0, 1, (4, 5 * world))),
            "v": _t(rng.normal(0, 1, (4, 5)))}


def _collective_refs(c, world):
    """The unsharded ops' outputs and each rank block's input gradient."""
    def grad_of(fn, x, w):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        (g,) = torch.autograd.grad((y * y * w).sum(), x)
        return y.detach(), g

    out = {"sum": grad_of(lambda x: x.sum(0), c["x"], c["w"]),
           "min": grad_of(lambda x: x.amin(0), c["ties"], c["w"]),
           "max": grad_of(lambda x: x.amax(0), c["ties"], c["w"]),
           "all_gather": grad_of(lambda x: torch.cat(list(x), dim=-1), c["x"], c["wide"])}
    y, g = grad_of(lambda x: x.amin(-2), c["table"], c["w"])
    out["reduce_min"] = (y, g.reshape(world, -1, 5))
    v = c["v"].clone().requires_grad_(True)
    total = (v[None] * c["x"]).sum()
    (gv,) = torch.autograd.grad(total * total, v)
    out["pvary"] = (total.detach(), gv)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs, the ranks' results for each world size, the references."""
    import jax
    import jax.numpy as jnp

    from lapgnn_tpu.models import DualGNN as JDualGNN
    from lapgnn_tpu.models import OneGNN as JOneGNN
    from lapgnn_tpu.ops.features import graph_features as j_graph_features
    from lapgnn_tpu.ops.features import row_features as j_row_features
    from lapgnn_tpu_torch.data.h5io import H5Writer
    from lapgnn_tpu_torch.data.synthetic import generate_synthetic_instance, instance_record
    from lapgnn_tpu_torch.train.convert import params_from_flax

    tmp = tmp_path_factory.mktemp("train_ranks")
    dp_cost = _costs(DP_N, DP_B, 11)
    dp_u = np.random.default_rng(12).normal(0, 0.1, (DP_B, DP_N)).astype(np.float32)
    dual_cost = _costs(DUAL_N, DUAL_B, 13)
    dual_u = np.random.default_rng(14).normal(0, 0.1, (DUAL_B, DUAL_N)).astype(np.float32)
    edge_cost = _costs(EDGE_N, 1, 15)
    edge_u = np.zeros((1, EDGE_N), np.float32)

    jone = JOneGNN(hidden=DP_HIDDEN, layers=1, dropout=0.0)
    one_params = jax.jit(jone.init)(jax.random.key(0), jnp.zeros((1, DP_N, 21), jnp.float32),
                                    cost=jnp.zeros((1, DP_N, DP_N), jnp.float32))
    jdual = JDualGNN(hidden_dim=DUAL_HIDDEN, layers=DUAL_LAYERS, heads=DUAL_HEADS, dropout=0.0)
    feats = jax.eval_shape(j_graph_features, jnp.zeros((1, DUAL_N, DUAL_N), jnp.float32))
    dual_params = jax.jit(jdual.init)(jax.random.key(1), *(jnp.zeros(f.shape, f.dtype) for f in
                                                            (feats.edge_feat, feats.row_feat,
                                                             feats.col_feat)))
    one_params = jax.tree.map(np.asarray, one_params)
    dual_params = jax.tree.map(np.asarray, dual_params)
    jsmall = JDualGNN(hidden_dim=16, layers=1, heads=2, dropout=0.0)
    small_feats = jax.eval_shape(j_graph_features, jnp.zeros((1, 16, 16), jnp.float32))
    train_init = jax.tree.map(np.asarray, jax.jit(jsmall.init)(
        jax.random.key(2), *(jnp.zeros(f.shape, f.dtype) for f in
                             (small_feats.edge_feat, small_feats.row_feat, small_feats.col_feat))))
    rng = np.random.default_rng(16)
    synth = [generate_synthetic_instance(f, 16, rng) for f in ("uniform", "noisy_linear", "block", "uniform")]
    train = [instance_record(s) for s in synth]
    writer = H5Writer(tmp / "train.h5")
    for s in synth:
        writer.append(s)
    writer.close()

    inputs = {
        "coll": {w: _collective_inputs(w, 20 + w) for w in WORLDS},
        "dp_state": params_from_flax(one_params), "dp_cost": _t(dp_cost), "dp_u": _t(dp_u),
        "dual_state": params_from_flax(dual_params), "dual_cost": _t(dual_cost),
        "dual_u": _t(dual_u), "edge_cost": _t(edge_cost), "edge_u": _t(edge_u),
        "train": train, "train_init": train_init, "h5": str(tmp / "train.h5"),
    }

    def run_world(w):
        torch.save(inputs, tmp / f"in{w}.pt")
        out = tmp / f"out{w}"
        out.mkdir()
        spawn_ranks(_rank_checks, w, args=(w, str(tmp / f"in{w}.pt"), str(out)),
                    init_method=f"file://{tmp}/store{w}", timeout=300, pg_timeout=60)
        return {"ranks": [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(w)], "dir": out}

    pool = ThreadPoolExecutor(1)
    running = pool.submit(lambda: {w: run_world(w) for w in WORLDS})
    refs = {"dp": _dp_refs(inputs, one_params, jone, j_row_features),
            "dual": _dual_refs(inputs, dual_params, jdual, j_graph_features),
            "coll": {w: _collective_refs(inputs["coll"][w], w) for w in WORLDS}}
    worlds = running.result()
    pool.shutdown()
    return {"inputs": inputs, "refs": refs, "worlds": worlds}


def _dp_refs(inputs, params, jmodel, j_row_features):
    """JAX's single-device ``make_train_step`` loss; the port's unsharded
    step's loss, gradients and updated parameters."""
    import jax
    import jax.numpy as jnp

    from lapgnn_tpu.train.schedule import make_optimizer as j_make_optimizer
    from lapgnn_tpu.train.trainer import State, make_train_step as j_make_train_step
    from lapgnn_tpu_torch.models import OneGNN
    from lapgnn_tpu_torch.train.schedule import make_optimizer
    from lapgnn_tpu_torch.train.trainer import make_train_step

    tx = j_make_optimizer(LR)
    _, jm = j_make_train_step(jmodel, tx, use_cost=True)(
        State(params, tx.init(params), jnp.asarray(0)), jnp.asarray(inputs["dp_cost"].numpy()),
        jnp.asarray(inputs["dp_u"].numpy()), jax.random.key(1))
    model = OneGNN(hidden=DP_HIDDEN, layers=1, dropout=0.0)
    model.load_state_dict(inputs["dp_state"])
    old = [p.detach().clone() for p in model.parameters()]
    opt = make_optimizer(list(model.parameters()), LR)
    seen = []
    real = opt.step
    opt.step = lambda g: (seen.append([x.clone() for x in g]), real(g))
    m = make_train_step(model, opt, use_cost=True)(inputs["dp_cost"], inputs["dp_u"])
    return {"jax_loss": float(jm["loss"]), "loss": float(m["loss"]),
            "names": [n for n, _ in model.named_parameters()],
            "metrics": {k: float(v) for k, v in m.items()}, "grads": seen[0], "old": old,
            "params": [p.detach().clone() for p in opt.params]}


def _dual_refs(inputs, params, jmodel, j_graph_features):
    """JAX's single-device forward and min-trick, and its replicated step:
    ``jax.value_and_grad`` of ``dual_gnn_loss(include_primal=False)`` and the
    optimizer's update."""
    import jax
    import jax.numpy as jnp
    import optax

    from lapgnn_tpu.ops.dual import min_trick_v
    from lapgnn_tpu.train.loss import dual_gnn_loss
    from lapgnn_tpu.train.schedule import make_optimizer as j_make_optimizer
    from lapgnn_tpu_torch.train.convert import params_from_flax

    C = jnp.asarray(inputs["dual_cost"].numpy())
    u_t = jnp.asarray(inputs["dual_u"].numpy())

    @jax.jit
    def forward_and_step(params):
        gf = j_graph_features(C)
        preds = jmodel.apply(params, gf.edge_feat, gf.row_feat, gf.col_feat)

        def loss_fn(p):
            pr = jmodel.apply(p, gf.edge_feat, gf.row_feat, gf.col_feat)
            return dual_gnn_loss(C, pr, normalize_gap=True, clip_sentinels=True, u_target=u_t,
                                 include_primal=False)[0]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        tx = j_make_optimizer(LR)
        upd, _ = tx.update(grads, tx.init(params), params)
        return preds["u"], min_trick_v(C, preds["u"]), preds["v_hint"], loss, grads, \
            optax.apply_updates(params, upd)

    u, v, v_hint, loss, grads, new = forward_and_step(jax.tree.map(jnp.asarray, params))
    as_sd = lambda tree: params_from_flax(jax.tree.map(np.asarray, tree))  # noqa: E731
    return {"u": np.asarray(u), "v": np.asarray(v), "v_hint": np.asarray(v_hint),
            "loss": float(loss), "grads": as_sd(grads), "params": as_sd(new),
            "old": as_sd(params)}


def _close_update(new, ref_new, old, ref_grad, g_all_max, atol):
    """``new`` within ``atol`` of ``ref_new``, except where the reference
    gradient is within the gradients' tolerance (1e-4 max|g| + 1e-7) of 0:
    there its sign is not determined and the first AdamW step moves the
    entry lr times that sign, either way, so the entry is held to a step of
    at most lr(1 + 1e-3)."""
    sign_free = ref_grad.abs() <= 1e-4 * g_all_max + 1e-7
    step = (new - old).abs()
    assert bool((step[sign_free] <= LR * (1 + 1e-3)).all())
    err = (new - ref_new).abs()[~sign_free]
    assert err.numel() == 0 or float(err.max()) <= atol, float(err.max())


def _ranks(run, world):
    return run["worlds"][world]["ranks"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op", ["sum", "min", "max", "reduce_min", "all_gather", "pvary"])
def test_collective_gradients_equal_the_unsharded_ops(run, world, op):
    """Exact for the extremes and the gather; a SUM adds in gloo's order,
    so within 1e-6 relative there."""
    y_ref, g_ref = run["refs"]["coll"][world][op]
    for rank, res in enumerate(_ranks(run, world)):
        y, g = res["collectives"][op]
        want = g_ref if op == "pvary" else g_ref[rank]
        if op in ("sum", "pvary"):
            torch.testing.assert_close(y, y_ref, rtol=1e-6, atol=0)
            torch.testing.assert_close(g, want, rtol=1e-6, atol=0)
        else:
            assert torch.equal(y, y_ref) and torch.equal(g, want), (op, rank)


@pytest.mark.parametrize("world", WORLDS)
def test_collective_gradcheck_float64(run, world):
    for res in _ranks(run, world):
        assert all(res["collectives"]["gradcheck"].values()), res["collectives"]["gradcheck"]


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x2", "hierarchical"])
def test_dp_train_step_matches_jax_and_unsharded(run, mesh):
    world = 4 if mesh in ("2x2", "hierarchical") else 2
    ref = run["refs"]["dp"]
    ranks = [r["dp"][mesh] for r in _ranks(run, world)]
    held = [name != GAUGE_FREE for name in ref["names"]]
    g_max = max(float(g.abs().max()) for g, h in zip(ref["grads"], held) if h)
    d_max = max(float((p - o).abs().max()) for p, o in zip(ref["params"], ref["old"]))
    for res in ranks:
        loss = res["metrics"]["loss"]
        np.testing.assert_allclose(loss, ref["jax_loss"], rtol=1e-4)
        np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
        for k in ("primal_gap_mean", "feas_mean", "u_mse_mean"):
            np.testing.assert_allclose(res["metrics"][k], ref["metrics"][k], rtol=1e-5, atol=1e-7)
        for g, gr, h in zip(res["grads"], ref["grads"], held):
            assert not h or float((g - gr).abs().max()) <= 1e-4 * g_max + 1e-7
        for p, pr, o, gr, h in zip(res["params"], ref["params"], ref["old"], ref["grads"], held):
            _close_update(p, pr, o, gr if h else torch.zeros_like(gr), g_max, 1e-4 * d_max + 1e-7)
    for res in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(res["params"], ranks[0]["params"]))


@pytest.mark.parametrize("world", WORLDS)
def test_dp_train_step_collectives(run, world):
    """One all-reduce a parameter gradient, the greedy bound's two gathers
    of the rank's instances (rows split over 'model' only), and otherwise
    nothing larger than a vector of the block's instances' columns."""
    sizes = [p.numel() for p in run["refs"]["dp"]["params"]]
    for res in _ranks(run, world):
        for name, step in res["dp"].items():
            B, _, n = step["block"]
            log = [e[:2] for e in step["log"]]
            grads = [("all_reduce_sum", k) for k in sizes]
            starts = [i for i in range(len(log)) if log[i:i + len(grads)] == grads]
            assert len(starts) == 1, name
            rest = log[: starts[0]] + log[starts[0] + len(grads):]
            gathers = [e for e in rest if e[0] == "all_gather"]
            assert gathers == ([] if name == "rows_whole" else [("all_gather", B * n * n)] * 2)
            assert max(k for op, k in rest if op != "all_gather") <= B * n, name


def test_dp_train_step_rows_whole_sums_over_data_only(run):
    ref = run["refs"]["dp"]
    for world in WORLDS:
        for res in _ranks(run, world):
            step = res["dp"]["rows_whole"]
            np.testing.assert_allclose(step["metrics"]["loss"], ref["loss"], rtol=1e-5)
            assert not any(e[0] == "all_gather" for e in step["log"])


@pytest.mark.parametrize("project", [True, False])
@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x2"])
def test_sharded_dual_predict_matches_jax(run, mesh, project):
    world = 4 if mesh == "2x2" else 2
    ref = run["refs"]["dual"]
    for res in _ranks(run, world):
        u, v = res["dual_predict"][mesh][project]
        np.testing.assert_allclose(u.numpy(), ref["u"], atol=1e-5)
        np.testing.assert_allclose(v.numpy(), ref["v"] if project else ref["v_hint"], atol=1e-5)


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x2", "2x2-remat"])
def test_sharded_dual_train_step_matches_jax(run, mesh):
    world = 2 if mesh in ("2x1", "1x2") else 4
    ref = run["refs"]["dual"]
    ranks = [r["dual_remat"] if mesh.endswith("remat") else r["dual"][mesh]
             for r in _ranks(run, world)]
    g_max = max(float(g.abs().max()) for g in ref["grads"].values())
    for res in ranks:
        np.testing.assert_allclose(res["metrics"]["loss"], ref["loss"], atol=1e-5)
        assert set(res["grads"]) == set(ref["grads"])
        for name, g in res["grads"].items():
            assert float((g - ref["grads"][name]).abs().max()) <= 1e-4 * g_max + 1e-7, name
            _close_update(res["params"][name], ref["params"][name], ref["old"][name],
                          ref["grads"][name], g_max, 1e-5)
    for res in ranks[1:]:
        assert all(torch.equal(res["params"][k], ranks[0]["params"][k]) for k in res["params"])
        assert [e[0] for e in res["log"]] == [e[0] for e in ranks[0]["log"]]


def test_dual_remat_repeats_the_layers_collectives(run):
    ranks = _ranks(run, 4)
    plain, remat = ranks[0]["dual"]["2x2"]["log"], ranks[0]["dual_remat"]["log"]
    assert len(remat) > len(plain)
    for res in ranks:
        assert [e[:2] for e in res["dual_remat"]["log"]] == [e[:2] for e in remat]
        assert all(torch.equal(g, res["dual"]["2x2"]["grads"][k])
                   for k, g in res["dual_remat"]["grads"].items())


def test_no_edge_tensor_gather(run):
    from lapgnn_tpu_torch.parallel import assert_no_edge_tensor_gather

    limit = 3 * EDGE_N * EDGE_N // 2
    for res in _ranks(run, 4):
        for log in res["edge_logs"].values():
            assert_no_edge_tensor_gather(log, EDGE_N)
            assert 0 < max(e[1] for e in log) <= limit
        assert any(op.endswith(".backward") for op, _, _ in res["edge_logs"]["train"])
        assert "edge tensor" in res["planted_gather_caught"]
    with pytest.raises(AssertionError, match="edge tensor"):
        assert_no_edge_tensor_gather([("all_gather", limit + 1, "float32")], EDGE_N)


@pytest.mark.parametrize("world", WORLDS)
def test_dual_mesh_factorisation(run, world):
    res = _ranks(run, world)[0]
    shapes = res["dual_mesh_shapes"]
    want_auto = {"row": 2, "col": 1} if world == 2 else {"row": 2, "col": 2}
    assert shapes["auto"] == want_auto
    assert shapes["[('row', %d)]" % world] == {"row": world, "col": 1}
    assert shapes["[('col', %d)]" % world] == {"row": 1, "col": world}
    assert shapes["[('col', 1)]"] == {"row": world, "col": 1}
    errs = res["dual_mesh_errors"]
    assert "!= %d devices" % world in errs["[('col', 3), ('row', 3)]"]
    assert "does not divide" in errs["[('row', 3)]"] and "does not divide" in errs["[('col', 3)]"]


def test_train_dual_gnn_mesh_matches_jax(run, jax_init_by_shape):
    import jax

    from lapgnn_tpu.parallel.dual import dual_mesh as j_dual_mesh
    from lapgnn_tpu.train.dual_trainer import DualTrainConfig as JConfig
    from lapgnn_tpu.train.dual_trainer import train_dual_gnn as j_train

    inp = run["inputs"]
    cfg = dict(hidden=16, layers=1, heads=2, epochs=2, batch_size=2, dropout=0.0, min_epochs=1)
    _, want = j_train(inp["train"], inp["train"][:2], JConfig(**cfg), log_fn=lambda s: None,
                      mesh=j_dual_mesh(row=4, col=2), init_params=inp["train_init"])
    for world in WORLDS:
        ranks = _ranks(run, world)
        for res in ranks:
            got = res["train"]["history"]
            assert len(got["train_loss"]) == 2 and got == ranks[0]["train"]["history"]
            for key in ("train_loss", "val_gap_median"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
        assert ranks[0]["train"]["logs"] and not any(r["train"]["logs"] for r in ranks[1:])
        leaves = [jax.tree_util.tree_leaves(r["train"]["params"]) for r in ranks]
        assert all(all(np.array_equal(a, b) for a, b in zip(lv, leaves[0])) for lv in leaves)


def test_train_dual_gnn_cli_mesh_2d_writes_on_rank_0(run):
    from lapgnn_tpu_torch.train import load_checkpoint

    out = run["worlds"][2]["dir"]
    assert not (out / "ckpt1").exists()
    params, meta, _ = load_checkpoint(out / "ckpt0")
    assert meta["architecture"] == "dual_gnn" and len(meta["history"]["train_loss"]) == 1
