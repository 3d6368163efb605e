"""The port's row-sharded serving (``lapgnn_tpu_torch.parallel``) on the CPU.

Each world size (1, 2, 4) runs once, as gloo ranks in spawned processes
(``parallel.launch.spawn_ranks``: a file rendezvous, a 60 s timeout on every
collective and a deadline on the whole run); every check of that world size
runs inside it and the ranks write what they computed to files that the
tests read.  The worlds run one after another while this process computes
the references.  The pytest process itself never joins a process group.  The inputs are made
here with numpy from fixed seeds and handed to the ranks; the references
are computed here: the port's unsharded functions, and JAX's (its sharded
solve, ``shmap_*`` and ``ring_*`` on the 8-device virtual CPU mesh of
tests/conftest.py, its unsharded ``predict_duals_fn``).

  * The sharded seeded solve is bit-equal (x, y, v, the implied u, cost) to
    the port's unsharded ``lapjv_seeded_single`` at world 1, 2 and 4, on the
    eight families at n in {64, 256} from rank-1 seeds and on a planted
    instance, and agrees with JAX's sharded solve in cost (rel 1e-6) and in
    optimality (SciPy).
  * ``shmap_col_min`` / ``shmap_min_trick`` / ``ring_all_reduce_min`` /
    ``ring_min_trick`` are bit-equal to JAX's and to the unsharded functions.
  * ``make_sharded_predict`` (data 2 x model 2, hidden 32, 1 layer, n = 32,
    batch 4) is within atol 1e-5 of JAX's ``predict_duals_fn`` (the JAX
    test's tolerance), for seed_mode auto, rank1 and gnn.
  * ``make_sharded_pipeline`` on a planted n = 256 instance is optimal and
    agrees in cost with the same steps unsharded (rel 1e-6).
  * No collective of the solve or the pipeline moves an O(n^2) operand
    (``assert_no_matrix_allgather`` on every rank's log); the 'auto'
    predict's largest collective is at most 66,000 elements.
  * The hostmesh counterparts of the JAX tests.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from lapgnn_tpu_torch.data.generators import FAMILIES, generate_planted_optimum_instance
from lapgnn_tpu_torch.parallel.launch import spawn_ranks

WORLDS = (1, 2, 4)
FAMS = sorted(FAMILIES)
SOLVE_N = (64, 256)
PLANTED_N = 256
PRED_N, PRED_B, PRED_HIDDEN = 32, 4, 32
BUDGET_N = 512
RING_SHAPE = (64, 48)
SOLVE_CASES = ([f"{fam}-{n}" for fam in FAMS for n in SOLVE_N]
               + [f"planted-{PLANTED_N}", "uniform-64-float64"])


def _rank_checks(rank, world, in_path, out_dir):
    """Every check of one world size, on one rank; results to rank{rank}.pt."""
    torch.set_num_threads(1)
    from lapgnn_tpu_torch.models import OneGNN
    from lapgnn_tpu_torch.parallel import (
        batch_sharding, global_batch_from_host_local, local_rows, make_hierarchical_mesh,
        make_mesh, make_sharded_predict, ring_all_reduce_min, ring_min_trick, shmap_col_min,
        shmap_min_trick,
    )
    from lapgnn_tpu_torch.parallel.solver import (
        assert_no_matrix_allgather, make_sharded_pipeline, make_sharded_seeded_solve,
    )

    inp = torch.load(in_path)
    res = {"solve": {}, "solve_log": {}}
    mesh = make_mesh(data=1, model=world, device="cpu", timeout=60)
    solve = make_sharded_seeded_solve(mesh)
    for name, (C, u, v) in inp["solve"].items():
        mesh.log.clear()
        r = solve(local_rows(C, mesh), local_rows(u[:, None], mesh)[:, 0], v)
        res["solve"][name] = (r.col_of_row, r.row_of_col, r.v, r.cost, r.used_fallback)
        assert_no_matrix_allgather(mesh.log, C.shape[-1], world)
        res["solve_log"][name] = max((e[1] for e in mesh.log), default=0)

    C, u, x = inp["ring"]
    res["shmap_col_min"] = shmap_col_min(mesh)(local_rows(C, mesh))
    res["shmap_min_trick"] = shmap_min_trick(mesh)(local_rows(C, mesh), local_rows(u[:, None], mesh)[:, 0])
    res["ring_all_reduce_min"] = ring_all_reduce_min(mesh)(x[rank])
    res["ring_min_trick"] = ring_min_trick(mesh)(local_rows(C, mesh), local_rows(u[:, None], mesh)[:, 0])
    try:
        local_rows(C[:-1], mesh)
        res["uneven_split_raises"] = world == 1
    except ValueError:
        res["uneven_split_raises"] = True

    pipe_model = OneGNN(hidden=16, layers=1, dropout=0.0, topk=8)
    pipe_model.load_state_dict(inp["pipe_state"])
    mesh.log.clear()
    Cp = inp["planted"]
    r = make_sharded_pipeline(pipe_model.eval(), mesh)(local_rows(Cp, mesh))
    res["pipeline"] = (r.col_of_row, r.cost)
    assert_no_matrix_allgather(mesh.log, Cp.shape[-1], world)
    res["pipeline_log"] = max((e[1] for e in mesh.log), default=0)

    if world == 4:
        res["mesh_shapes"] = (make_mesh(data=2, model=2, device="cpu").shape,
                              make_mesh(model=2, device="cpu").shape)
        try:
            make_mesh(data=3, model=2, device="cpu")
        except ValueError as exc:
            res["mesh_mismatch"] = str(exc)
        model = OneGNN(hidden=PRED_HIDDEN, layers=1)
        model.load_state_dict(inp["pred_state"])
        model.eval()
        mesh22 = make_mesh(data=2, model=2, device="cpu", timeout=60)
        block = batch_sharding(mesh22, shard_n=True).local(inp["pred_cost"])
        res["predict"] = {mode: make_sharded_predict(model, mesh22, seed_mode=mode)(block)
                          for mode in ("auto", "rank1", "gnn")}
        ctx_model = OneGNN(hidden=16, layers=1, context=True)
        ctx_model.load_state_dict(inp["ctx_state"])
        res["predict_context"] = make_sharded_predict(ctx_model.eval(), mesh22, seed_mode="gnn")(block)
        mesh14 = make_mesh(data=1, model=4, device="cpu", timeout=60)
        make_sharded_predict(model, mesh14)(local_rows(inp["budget_cost"], mesh14))
        res["budget_log_max"] = max(e[1] for e in mesh14.log)

        hmesh = make_hierarchical_mesh(model=2, devices_per_host=2, device="cpu")
        res["hier"] = (hmesh.shape, hmesh.ranks.tolist())
        for key, kw in (("hier_dcn", dict(model=4, devices_per_host=2)),
                        ("hier_divisible", dict(model=1, devices_per_host=3))):
            try:
                make_hierarchical_mesh(device="cpu", **kw)
            except ValueError as exc:
                res[key] = str(exc)
        batch = inp["host_batch"]
        d = hmesh.coordinate("data")
        half = batch.shape[0] // hmesh.size("data")
        res["host_block"] = global_batch_from_host_local(hmesh, batch[d * half:(d + 1) * half])
        try:
            global_batch_from_host_local(hmesh, batch[: 1 + (rank == 0)])
        except ValueError as exc:
            res["host_mismatch"] = str(exc)
    torch.save(res, f"{out_dir}/rank{rank}.pt")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _rank1_seed(C):
    from lapgnn_tpu_torch.ops.dual import min_trick_v
    from lapgnn_tpu_torch.ops.rank1 import rank1_duals

    u, _ = rank1_duals(C)
    return u, min_trick_v(C, u)


def _unsharded_pipeline(model, C):
    """make_sharded_pipeline's steps on the whole matrix, with the port's
    unsharded functions."""
    from lapgnn_tpu_torch.ops.dual import robust_normalize
    from lapgnn_tpu_torch.ops.features import row_features
    from lapgnn_tpu_torch.ops.rank1 import rank1_duals, select_best_seed
    from lapgnn_tpu_torch.solver.seeded import lapjv_seeded_single

    with torch.inference_mode():
        C_in, mn, a = robust_normalize(C[None])
        u = model(row_features(C_in), cost=C_in)["u"][0] * a + mn
        u, v = select_best_seed(C, (u, rank1_duals(C[None])[0][0]))
        return lapjv_seeded_single(C, u, v, gate="both")


def _opt(C):
    import scipy.optimize

    C64 = np.asarray(C, np.float64)
    r, c = scipy.optimize.linear_sum_assignment(C64)
    return float(C64[r, c].sum())


def _cost64(C, x):
    x = np.asarray(x)
    return float(np.asarray(C, np.float64)[np.arange(len(x)), x].sum())


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Inputs, the port's unsharded references and JAX's references."""
    import jax
    import jax.numpy as jnp

    from lapgnn_tpu.models import OneGNN as JOneGNN
    from lapgnn_tpu.parallel import make_mesh as j_make_mesh
    from lapgnn_tpu.parallel import ring_all_reduce_min, ring_min_trick, shmap_col_min, shmap_min_trick
    from lapgnn_tpu.parallel.solver import make_sharded_seeded_solve as j_solve
    from lapgnn_tpu.pipeline import predict_duals_fn
    from lapgnn_tpu_torch.models import OneGNN
    from lapgnn_tpu_torch.solver.seeded import lapjv_seeded_single
    from lapgnn_tpu_torch.train.convert import params_from_flax

    solve_in, unsharded = {}, {}
    for k, fam in enumerate(FAMS):
        for n in SOLVE_N:
            C = _t(FAMILIES[fam](n, np.random.default_rng(100 * k + n)))
            solve_in[f"{fam}-{n}"] = (C, *_rank1_seed(C))
    Cp, up, _, opt_p = generate_planted_optimum_instance(PLANTED_N, seed=7, dtype=np.float32)
    Cp = _t(Cp)
    solve_in[f"planted-{PLANTED_N}"] = (Cp, _t(up), (Cp - _t(up)[:, None]).amin(0))
    C64 = torch.from_numpy(FAMILIES["uniform"](64, np.random.default_rng(64)))
    solve_in["uniform-64-float64"] = (C64, *_rank1_seed(C64))

    rng = np.random.default_rng(3)
    C_ring = _t(FAMILIES["uniform"](RING_SHAPE[0], rng)[:, : RING_SHAPE[1]])
    u_ring = _t(rng.normal(0, 0.3, RING_SHAPE[0]))
    x_ring = {w: _t(rng.normal(0, 1, (w, 16))) for w in WORLDS}

    torch.manual_seed(0)
    pipe_model = OneGNN(hidden=16, layers=1, dropout=0.0, topk=8).eval()
    ctx_model = OneGNN(hidden=16, layers=1, context=True).eval()

    jmodel = JOneGNN(hidden=PRED_HIDDEN, layers=1)
    pred_cost = np.stack([FAMILIES["uniform"](PRED_N, rng) for _ in range(PRED_B)]).astype(np.float32)
    Cd = jnp.asarray(pred_cost)
    # the weights depend on the shapes only; jitted, the init takes a second
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, PRED_N, 21), jnp.float32),
                                  cost=jnp.zeros((1, PRED_N, PRED_N), jnp.float32))

    tmp = tmp_path_factory.mktemp("ranks")
    inputs = {
        "solve": solve_in, "planted": Cp,
        "pipe_state": pipe_model.state_dict(), "ctx_state": ctx_model.state_dict(),
        "pred_state": params_from_flax(jax.tree.map(np.asarray, params)),
        "pred_cost": torch.from_numpy(pred_cost),
        "budget_cost": _t(FAMILIES["uniform"](BUDGET_N, rng))[None],
        "host_batch": torch.arange(8 * 4 * 4, dtype=torch.float32).reshape(8, 4, 4),
    }

    def run_world(w):
        torch.save(dict(inputs, ring=(C_ring, u_ring, x_ring[w])), tmp / f"in{w}.pt")
        out = tmp / f"out{w}"
        out.mkdir()
        spawn_ranks(_rank_checks, w, args=(w, str(tmp / f"in{w}.pt"), str(out)),
                    init_method=f"file://{tmp}/store{w}", timeout=240, pg_timeout=60)
        return [torch.load(out / f"rank{r}.pt") for r in range(w)]

    pool = ThreadPoolExecutor(1)
    running = pool.submit(lambda: {w: run_world(w) for w in WORLDS})

    for name, (C, u, v) in solve_in.items():
        unsharded[name] = lapjv_seeded_single(C, u, v, gate="both")
    pipe_ref = _unsharded_pipeline(pipe_model, Cp)
    with torch.inference_mode():
        from lapgnn_tpu_torch.ops.dual import min_trick_v
        from lapgnn_tpu_torch.ops.features import row_features

        pc = torch.from_numpy(pred_cost)
        u_ctx = ctx_model(row_features(pc), cost=pc)["u"]
        ctx_ref = (u_ctx, min_trick_v(pc, u_ctx))
    pred_ref = {mode: tuple(np.asarray(a) for a in predict_duals_fn(jmodel, seed_mode=mode)(params, Cd))
                for mode in ("auto", "rank1", "gnn")}

    jax_ref = {"shmap_col_min": {}, "shmap_min_trick": {}, "ring_all_reduce_min": {},
               "ring_min_trick": {}, "solve": {}}
    Cj, uj = jnp.asarray(C_ring.numpy()), jnp.asarray(u_ring.numpy())
    Cpj, upj, vpj = (jnp.asarray(t.numpy()) for t in solve_in[f"planted-{PLANTED_N}"])
    for w in WORLDS:
        mesh = j_make_mesh(data=1, model=w)
        with mesh:
            jax_ref["shmap_col_min"][w] = np.asarray(shmap_col_min(mesh)(Cj))
            jax_ref["shmap_min_trick"][w] = np.asarray(shmap_min_trick(mesh)(Cj, uj))
            jax_ref["ring_all_reduce_min"][w] = np.asarray(
                ring_all_reduce_min(mesh)(jnp.asarray(x_ring[w].numpy())))
            jax_ref["ring_min_trick"][w] = np.asarray(ring_min_trick(mesh)(Cj, uj))
        if w > 1:
            jax_ref["solve"][w] = np.asarray(j_solve(mesh)(Cpj, upj, vpj).col_of_row)

    with pool:
        ranks = running.result()
    return {"solve_in": solve_in, "unsharded": unsharded, "ring": (C_ring, u_ring, x_ring),
            "planted": (Cp, opt_p), "pipe_ref": pipe_ref, "pred_cost": pred_cost,
            "pred_ref": pred_ref, "ctx_ref": ctx_ref, "jax": jax_ref, "ranks": ranks}


def _bits(t):
    return t.numpy().view(np.uint64 if t.dtype == torch.float64 else np.uint32)


@pytest.mark.parametrize("name", SOLVE_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_solve_bit_equal_to_unsharded(case, world, name):
    ref = case["unsharded"][name]
    C = case["solve_in"][name][0]
    n = C.shape[-1]
    for res in case["ranks"][world]:
        x, y, v, cost, fallback = res["solve"][name]
        np.testing.assert_array_equal(x.numpy(), ref.col_of_row.numpy())
        np.testing.assert_array_equal(y.numpy(), ref.row_of_col.numpy())
        np.testing.assert_array_equal(_bits(v), _bits(ref.v))
        assert bool(fallback) == bool(ref.used_fallback)
        np.testing.assert_array_equal(_bits(cost.reshape(1)), _bits(ref.cost.reshape(1)))
        # the implied row duals u_i = C[i, x_i] - v[x_i]
        u = C[torch.arange(n), x] - v[x]
        u_ref = C[torch.arange(n), ref.col_of_row] - ref.v[ref.col_of_row]
        np.testing.assert_array_equal(_bits(u), _bits(u_ref))
    assert sorted(ref.col_of_row.tolist()) == list(range(n))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_solve_matches_jax_and_optimal(case, world):
    Cp, opt = case["planted"]
    x = case["ranks"][world][0]["solve"][f"planted-{PLANTED_N}"][0].numpy()
    xj = case["jax"]["solve"][world]
    assert sorted(x.tolist()) == list(range(PLANTED_N))
    assert _cost64(Cp, x) == pytest.approx(_cost64(Cp, xj), rel=1e-6)
    assert _cost64(Cp, x) == pytest.approx(_opt(Cp), rel=1e-5)
    assert _cost64(Cp, x) == pytest.approx(opt, rel=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_solve_optimal_on_every_family(case, world):
    for name, (C, _, _) in case["solve_in"].items():
        x = case["ranks"][world][0]["solve"][name][0].numpy()
        n = C.shape[-1]
        got, opt = _cost64(C, x), _opt(C)
        # the float32 solve's polish threshold, n times over (tests/test_torch_solver.py)
        assert abs(got - opt) <= n * 8 * 2.0**-23 * (1 + float(C.abs().max())), name


@pytest.mark.parametrize("world", WORLDS)
def test_solve_collectives_are_o_n(case, world):
    """Every rank's solve ran ``assert_no_matrix_allgather`` on its log; the
    largest collective is also at most a few vectors of n + 1.  At world 1
    the solve makes no collective at all (``ShardedRows`` of one rank is
    ``RowPartition``)."""
    for res in case["ranks"][world]:
        for name, biggest in res["solve_log"].items():
            n = case["solve_in"][name][0].shape[-1]
            if world == 1:
                assert biggest == 0, (name, biggest)
            else:
                assert 0 < biggest <= 8 * n, (name, biggest)


def test_assert_no_matrix_allgather_rejects_a_matrix_gather():
    from lapgnn_tpu_torch.parallel.solver import assert_no_matrix_allgather

    n, shards = 256, 4
    ok = [("all_reduce_min", n + 1, "float32"), ("all_gather", n, "int64")]
    assert_no_matrix_allgather(ok, n, shards)
    with pytest.raises(AssertionError, match="replicated"):
        assert_no_matrix_allgather(ok + [("all_gather", n * n // shards, "float32")], n, shards)


@pytest.mark.parametrize("what", ["shmap_col_min", "shmap_min_trick", "ring_min_trick"])
@pytest.mark.parametrize("world", WORLDS)
def test_column_reductions_bit_equal(case, world, what):
    from lapgnn_tpu_torch.ops.cuda.colmin import col_min_plain, min_trick_plain

    C, u, _ = case["ring"]
    want = col_min_plain(C) if what == "shmap_col_min" else min_trick_plain(C, u)
    for res in case["ranks"][world]:
        np.testing.assert_array_equal(_bits(res[what]), _bits(want))
        np.testing.assert_array_equal(_bits(res[what]), case["jax"][what][world].view(np.uint32))


@pytest.mark.parametrize("world", WORLDS)
def test_ring_all_reduce_min_bit_equal(case, world):
    x = case["ring"][2][world]
    for res in case["ranks"][world]:
        got = res["ring_all_reduce_min"]
        np.testing.assert_array_equal(_bits(got), _bits(x.amin(0)))
        np.testing.assert_array_equal(_bits(got), case["jax"]["ring_all_reduce_min"][world].view(np.uint32))


@pytest.mark.parametrize("world", WORLDS)
def test_local_rows_refuses_an_uneven_split(case, world):
    assert all(res["uneven_split_raises"] for res in case["ranks"][world])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pipeline_optimal_and_agrees(case, world):
    Cp, opt = case["planted"]
    ref = case["pipe_ref"]
    for res in case["ranks"][world]:
        x, cost = res["pipeline"]
        assert sorted(x.tolist()) == list(range(PLANTED_N))
        assert _cost64(Cp, x) == pytest.approx(_cost64(Cp, ref.col_of_row), rel=1e-6)
        assert float(cost) == pytest.approx(float(ref.cost), rel=1e-6)
        assert _cost64(Cp, x) == pytest.approx(opt, rel=1e-5)
        if world == 1:  # one rank: no collective
            assert res["pipeline_log"] == 0
        else:
            assert 0 < res["pipeline_log"] <= max(8 * PLANTED_N, PLANTED_N * PLANTED_N // world // 4)


@pytest.mark.parametrize("mode", ["auto", "rank1", "gnn"])
def test_sharded_predict_matches_jax(case, mode):
    u_ref, v_ref = case["pred_ref"][mode]
    u = np.zeros_like(u_ref)
    half_b, half_n = PRED_B // 2, PRED_N // 2
    for r, res in enumerate(case["ranks"][4]):
        d, k = divmod(r, 2)
        ub, vb = res["predict"][mode]
        u[d * half_b:(d + 1) * half_b, k * half_n:(k + 1) * half_n] = ub.numpy()
        np.testing.assert_allclose(vb.numpy(), v_ref[d * half_b:(d + 1) * half_b], atol=1e-5)
    np.testing.assert_allclose(u, u_ref, atol=1e-5)


def test_sharded_predict_with_global_context(case):
    """A OneGNN with the global context pools its rows across ranks: the
    sharded 'gnn' predict equals the unsharded model within 1e-5."""
    u_ref, v_ref = (t.numpy() for t in case["ctx_ref"])
    half_b, half_n = PRED_B // 2, PRED_N // 2
    for r, res in enumerate(case["ranks"][4]):
        d, k = divmod(r, 2)
        ub, vb = res["predict_context"]
        np.testing.assert_allclose(ub.numpy(), u_ref[d * half_b:(d + 1) * half_b,
                                                     k * half_n:(k + 1) * half_n], atol=1e-5)
        np.testing.assert_allclose(vb.numpy(), v_ref[d * half_b:(d + 1) * half_b], atol=1e-5)


def test_sharded_predict_modes_differ(case):
    """The GNN-only seed is not the 'auto' one on this batch (the policy ran)."""
    ranks = case["ranks"][4]
    assert not all(torch.allclose(r["predict"]["gnn"][0], r["predict"]["auto"][0], atol=1e-3)
                   for r in ranks)


def test_auto_predict_collective_budget(case):
    """The 'auto' policy's largest collective is the bounded quantile sample
    (65,536 entries at n = 512); the matrix stays sharded."""
    for res in case["ranks"][4]:
        assert res["budget_log_max"] <= 66000


def test_make_mesh_shapes(case):
    res = case["ranks"][4][0]
    assert res["mesh_shapes"][0] == {"data": 2, "model": 2}
    assert res["mesh_shapes"][1]["data"] * 2 == 4
    assert "needs 6 devices, have 4" in res["mesh_mismatch"]


def test_hierarchical_mesh_model_axis_stays_in_host(case):
    """Two simulated hosts of two ranks: each model group lies in one host
    and every rank is used once."""
    for res in case["ranks"][4]:
        shape, grid = res["hier"]
        assert shape == {"data": 2, "model": 2}
        for row in grid:
            assert len({r // 2 for r in row}) == 1
        assert sorted(r for row in grid for r in row) == [0, 1, 2, 3]


def test_hierarchical_mesh_rejects_model_axis_across_hosts(case):
    for res in case["ranks"][4]:
        assert "ICI" in res["hier_dcn"]
        assert "divisible" in res["hier_divisible"]


def test_global_batch_from_host_local(case):
    batch = torch.arange(8 * 4 * 4, dtype=torch.float32).reshape(8, 4, 4)
    for r, res in enumerate(case["ranks"][4]):
        d, k = divmod(r, 2)
        np.testing.assert_array_equal(res["host_block"].numpy(),
                                      batch[d * 4:(d + 1) * 4, k * 2:(k + 1) * 2].numpy())
        assert "different shapes" in res["host_mismatch"]


def test_initialize_distributed_noop_without_coordinator(monkeypatch):
    from lapgnn_tpu_torch.parallel import initialize_distributed

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    assert initialize_distributed(device="cpu") is False


def test_initialize_distributed_rejects_partial_config(monkeypatch):
    from lapgnn_tpu_torch.parallel import initialize_distributed

    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="num_processes"):
        initialize_distributed(device="cpu")
