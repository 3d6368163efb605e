"""The plain references stand apart from the program: their imports name
nothing of it or of JAX, and what they compute agrees with the program at
small sizes on the CPU."""

import ast

import numpy as np
import pytest
import torch

from conftest import ROOT

REFERENCE_FILES = sorted((ROOT / "lapbench" / "reference").glob("*.py"))
BANNED = ("lapgnn_tpu_torch", "lapgnn_tpu", "jax", "jaxlib", "flax")


@pytest.mark.parametrize("path", REFERENCE_FILES, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
            assert node.level == 0, f"{path.name}: relative import"
    for name in names:
        assert name.split(".")[0] not in BANNED, (path.name, name)
        assert not name.startswith("lapbench"), (path.name, name)


def test_families_import_nothing_of_the_program():
    tree = ast.parse((ROOT / "lapbench" / "families.py").read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert all(m.split(".")[0] not in BANNED for m in mods)


@pytest.mark.parametrize("family", ["uniform", "metric", "low_rank", "block", "noisy_linear", "tie", "sparse"])
def test_frozen_families_equal_the_programs(family):
    from lapbench.families import FAMILIES
    from lapgnn_tpu_torch.data.generators import FAMILIES as PROGRAM

    a = FAMILIES[family](33, np.random.default_rng(5))
    b = PROGRAM[family](33, np.random.default_rng(5))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("checkpoint", ["dual_gnn_r5", "one_gnn_default"])
def test_msgpack_reader_reads_what_the_program_loads(checkpoint):
    from lapbench.reference.dual_gnn import read_msgpack_params
    from lapgnn_tpu_torch.train.checkpoint import load_checkpoint

    mine = read_msgpack_params((ROOT / "artifacts" / checkpoint / "params.msgpack").read_bytes())
    params, _, _ = load_checkpoint(ROOT / "artifacts" / checkpoint)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(params.get("params", params), "")
    assert set(mine) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(mine[k], flat[k])


@pytest.mark.parametrize("n", [7, 16])
def test_reference_graph_features_match_the_programs(n):
    from lapbench.reference.dual_gnn import graph_features
    from lapgnn_tpu_torch.ops.features import graph_features as program

    C = torch.rand(2, n, n, generator=torch.Generator().manual_seed(n))
    C[0, 1, :3] = C[0, 1, 3]  # ties
    row, col, edge = graph_features(C)
    gf = program(C)
    torch.testing.assert_close(row, gf.row_feat, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(col, gf.col_feat, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(edge, gf.edge_feat, rtol=1e-5, atol=1e-6)


def test_reference_greedy_matches_the_programs():
    from lapbench.reference.dual_gnn import greedy_upper
    from lapgnn_tpu_torch.train.loss import greedy_primal_upper

    g = torch.Generator().manual_seed(3)
    cost = torch.rand(3, 20, 20, generator=g)
    red = cost - torch.rand(3, 20, 1, generator=g)
    assert torch.equal(greedy_upper(cost, red), greedy_primal_upper(cost, red))


def test_optimal_duals_are_feasible_and_tight():
    from lapbench.families import FAMILIES
    from lapbench.reference import lap

    for fam in ("uniform", "sparse", "tie"):
        C = FAMILIES[fam](30, np.random.default_rng(1))
        (opt, x), = lap.optima([C])
        u = lap.optimal_duals(C, x, torch.device("cpu"))
        v = (C - u[:, None]).min(0)
        assert (C - u[:, None] - v[None, :]).min() >= -1e-9
        assert u.sum() + v.sum() == pytest.approx(opt, rel=1e-12, abs=1e-9)


def test_optimal_duals_refuse_a_suboptimal_assignment():
    from lapbench.reference import lap

    C = np.array([[0.0, 1.0], [1.0, 0.0]])
    with pytest.raises(ArithmeticError):
        lap.optimal_duals(C, np.array([1, 0]), torch.device("cpu"))


def test_optimal_duals_of_a_stack_equal_each_alone():
    from lapbench.families import FAMILIES
    from lapbench.reference import lap

    Cs = [FAMILIES[fam](24, np.random.default_rng(5)) for fam in ("uniform", "block", "tie", "sparse")]
    xs = [x for _, x in lap.optima(Cs)]
    stacked = lap.optimal_duals(np.stack(Cs), np.stack(xs), torch.device("cpu"))
    for C, x, u in zip(Cs, xs, stacked):
        np.testing.assert_array_equal(u, lap.optimal_duals(C, x, torch.device("cpu")))
