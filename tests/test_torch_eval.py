"""The port's evaluation slice against the JAX package's: the rest of
``ops/dual``, ``select_best_seed``, ``ops/padding``, ``DualGNNPredictor``,
``evaluate_pipeline`` and the two evaluation CLIs.

Same inputs, made with numpy from a seed, through both packages on the CPU.
Each test states its tolerance.  ``evaluate_pipeline`` is held to the JAX
function run with x64 off, the package's default, under which it computes
the greedy bound and the feasibility check in float32, as the port does.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapgnn_tpu import evaluation as jeval
from lapgnn_tpu.data.generators import FAMILIES
from lapgnn_tpu.models import DualGNN as FlaxDualGNN
from lapgnn_tpu.models import OneGNN as FlaxOneGNN
from lapgnn_tpu.ops import dual as jdual
from lapgnn_tpu.ops import padding as jpad
from lapgnn_tpu.ops.rank1 import rank1_duals as j_rank1_duals
from lapgnn_tpu.ops.rank1 import select_best_seed as j_select_best_seed
from lapgnn_tpu.pipeline import WarmStartPipeline as JaxPipeline
from lapgnn_tpu.train.checkpoint import load_checkpoint as j_load
from lapgnn_tpu_torch import evaluation as teval
from lapgnn_tpu_torch.cli import accuracy_ladder, eval as eval_cli
from lapgnn_tpu_torch.data.synthetic import generate_synthetic_instance, instance_record
from lapgnn_tpu_torch.ops import dual as tdual
from lapgnn_tpu_torch.ops import padding as tpad
from lapgnn_tpu_torch.ops.rank1 import rank1_duals, select_best_seed
from lapgnn_tpu_torch.pipeline import WarmStartPipeline
from lapgnn_tpu_torch.solver.native import lapjv_native
from lapgnn_tpu_torch.train import (
    build_model_from_meta,
    load_checkpoint,
    params_from_flax,
    params_to_flax,
    save_checkpoint,
)

ROOT = Path(__file__).resolve().parent.parent
ONE_GNN = ROOT / "artifacts" / "one_gnn_default"
R5 = ROOT / "artifacts" / "dual_gnn_r5"
FAMS = tuple(FAMILIES)
N = 16
TIMING_KEYS = ("seeded_vs_cold_speedup_mean", "seeded_vs_cold_speedup_median")
LADDER_KEYS = ["u_mae", "u_mae_gauge", "v_mae", "feasible_rate", "assist_rate",
               "fallback_rate", "presolve_gap_median", "presolve_gap_clipped_median"]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _eq(got, want, what="", sum_scale=None):
    """A torch result and a JAX one bit-equal.  A result that went through a
    float64 sum, which torch and XLA add up in different orders, is given
    the sum of its terms' magnitudes as ``sum_scale`` and is held within
    64 ulp of it."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if sum_scale is None:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                                   atol=64 * np.finfo(np.float64).eps * sum_scale)


@pytest.fixture(scope="module")
def records():
    """One labelled instance of each family at n = 16 (SciPy optimum and
    difference-constraint duals)."""
    return [instance_record(generate_synthetic_instance(f, N, np.random.default_rng(40 + i)))
            for i, f in enumerate(FAMS)]


# ---------------------------------------------------------------- ops/dual


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fam", FAMS)
def test_dual_ops_match_jax_bit_for_bit(fam, masked):
    """``masked_fill``, ``reduced_costs``, ``tighten_rows``,
    ``project_feasible``, ``dual_objective``, ``check_dual_feasible``,
    ``check_complementary_slackness`` and ``duals_from_matching``, float64,
    on a batch of two instances of the family (the second with its last 5
    rows and columns masked): bit-equal to JAX, but for the two results that
    pass through a sum (``dual_objective`` and the gauge shift, a mean, of
    ``duals_from_matching``), held within 64 ulp of the sum of the terms'
    magnitudes (measured: 1-2 ulp of the result).  The feasibility and slackness flags are equal."""
    rng = np.random.default_rng(FAMS.index(fam))
    C = np.stack([FAMILIES[fam](N, rng) for _ in range(2)]).astype(np.float64)
    mask = np.ones((2, N), bool)
    mask[1, N - 5:] = False
    m = mask if masked else None
    if masked:
        # a masked instance is its valid block padded, as pad_batch leaves it
        C[1] = jpad.pad_cost_matrix(C[1, : N - 5, : N - 5], N)
    u = rng.normal(size=(2, N))
    v = rng.normal(size=(2, N))
    x = np.stack([lapjv_native(c)[0] for c in C]).astype(np.int64)

    def both(name, *args, **kw):
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
        targs = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
        jkw = {k: None if a is None else jnp.asarray(a) for k, a in kw.items()}
        tkw = {k: None if a is None else _t(a) for k, a in kw.items()}
        return getattr(tdual, name)(*targs, **tkw), getattr(jdual, name)(*jargs, **jkw)

    got, want = both("masked_fill", C, mask=m)
    _eq(got, want, "masked_fill")
    got, want = both("reduced_costs", C, u, v)
    _eq(got, want, "reduced_costs")
    got, want = both("tighten_rows", C, v, mask=m)
    _eq(got, want, "tighten_rows")
    (gu, gv), (wu, wv) = both("project_feasible", C, u + 3.0, v + 3.0, mask=m)
    _eq(gu, wu, "project_feasible u")
    _eq(gv, wv, "project_feasible v")
    got, want = both("dual_objective", gu.numpy(), gv.numpy(), mask=m)
    _eq(got, want, "dual_objective", sum_scale=float((gu.abs() + gv.abs()).sum(-1).max()))
    for uu, vv in ((u, v), (gu.numpy(), gv.numpy())):
        got, want = both("check_dual_feasible", C, uu, vv, mask=m)
        _eq(got, want, "check_dual_feasible")
    (du, dv), (ju, jv) = both("duals_from_matching", C, x, mask=m)
    scale = float(np.abs(np.concatenate([ju, jv], -1)).max())  # the means' terms
    _eq(du, ju, "duals_from_matching u", sum_scale=scale)
    _eq(dv, jv, "duals_from_matching v", sum_scale=scale)
    for uu, vv in ((du.numpy(), dv.numpy()), (u, v)):
        got = tdual.check_complementary_slackness(
            _t(C), _t(uu), _t(vv), _t(x), mask=None if m is None else _t(m))
        want = jdual.check_complementary_slackness(
            jnp.asarray(C), jnp.asarray(uu), jnp.asarray(vv), jnp.asarray(x),
            mask=None if m is None else jnp.asarray(m))
        _eq(got, want, "check_complementary_slackness")
    assert bool(tdual.check_complementary_slackness(_t(C), du, dv, _t(x)).all())


def test_dual_loops_stop_where_jax_stops():
    """``project_feasible`` at its round cap gives JAX's bits, and
    ``duals_from_matching`` with ``max_rounds`` cut short JAX's result (its
    gauge shift within a few ulp); ``masked_fill`` without a mask is the
    identity."""
    rng = np.random.default_rng(3)
    C = FAMILIES["uniform"](12, rng)[None]
    u, v = rng.normal(size=(1, 12)) + 5.0, rng.normal(size=(1, 12)) + 5.0
    for rounds in (0, 1):
        got = tdual.project_feasible(_t(C), _t(u), _t(v), max_rounds=rounds)
        want = jdual.project_feasible(jnp.asarray(C), jnp.asarray(u), jnp.asarray(v),
                                      max_rounds=rounds)
        for g, w in zip(got, want):
            _eq(g, w)
    x = lapjv_native(C[0])[0][None].astype(np.int64)
    got = tdual.duals_from_matching(_t(C), _t(x), max_rounds=1)
    want = jdual.duals_from_matching(jnp.asarray(C), jnp.asarray(x), max_rounds=1)
    scale = float(np.abs(np.concatenate(want, -1)).max())
    for g, w in zip(got, want):
        _eq(g, w, sum_scale=scale)
    c = _t(C)
    assert tdual.masked_fill(c, None) is c


@pytest.mark.parametrize("veto", [False, True])
def test_select_best_seed_matches_jax(veto):
    """Three candidates (the oracle u plus noise, the rank-1 duals, zeros)
    for one instance of each family, float64: the winning (u, v) bit-equal
    to JAX's, with and without the collision veto; unbatched too."""
    rng = np.random.default_rng(9)
    C = np.stack([FAMILIES[f](N, rng) for f in FAMS]).astype(np.float64)
    u_noisy = rng.normal(size=(len(FAMS), N))
    u_r1 = np.asarray(j_rank1_duals(jnp.asarray(C))[0])
    cands = (u_noisy, u_r1, np.zeros_like(u_noisy))
    got = select_best_seed(_t(C), tuple(_t(c) for c in cands), collision_veto=veto)
    want = j_select_best_seed(jnp.asarray(C), tuple(jnp.asarray(c) for c in cands),
                              collision_veto=veto)
    for g, w in zip(got, want):
        _eq(g, w)
    got1 = select_best_seed(_t(C[0]), tuple(_t(c[0]) for c in cands), collision_veto=veto,
                            min_trick=tdual.min_trick_v)
    for g, w in zip(got1, want):
        _eq(g, np.asarray(w)[0])


def test_padding_round_trips_match_jax():
    """``pad_batch`` of ragged instances, ``pad_cost_matrix`` and
    ``unpad_assignment`` equal JAX's; the padded optimum restricted to the
    valid block is the original optimum."""
    rng = np.random.default_rng(2)
    costs = [FAMILIES["uniform"](n, rng) for n in (5, 9, 7)]
    got, gmask = tpad.pad_batch(costs)
    want, wmask = jpad.pad_batch(costs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gmask, wmask)
    got8, _ = tpad.pad_batch(costs, target_n=12)
    assert got8.shape == (3, 12, 12)
    for b, c in enumerate(costs):
        n = c.shape[0]
        x_pad = lapjv_native(got[b])[0]
        x = tpad.unpad_assignment(x_pad, n)
        np.testing.assert_array_equal(x, jpad.unpad_assignment(x_pad, n))
        assert c[np.arange(n), x].sum() == pytest.approx(lapjv_native(c)[2], rel=1e-12)
    assert tpad.pad_cost_matrix(costs[0], 5) is costs[0] or np.array_equal(
        tpad.pad_cost_matrix(costs[0], 5), costs[0])
    with pytest.raises(ValueError):
        tpad.pad_cost_matrix(costs[1], 4)
    with pytest.raises(ValueError):
        tpad.pad_batch([])
    with pytest.raises(ValueError):
        tpad.unpad_assignment(np.array([5, 0, 1, 2, 3]), 4)


# ------------------------------------------------------ DualGNNPredictor


@pytest.fixture(scope="module")
def small_dual(tmp_path_factory):
    """A DualGNN at hidden 32, 2 layers, 4 heads with the port's random
    initial weights, saved as a checkpoint by the port's writer."""
    torch.manual_seed(0)
    meta = {"architecture": "dual_gnn", "hidden": 32, "layers": 2, "heads": 4,
            "dropout": 0.0, "node_feat_dim": 14, "edge_feat_dim": 10}
    path = tmp_path_factory.mktemp("dual") / "ckpt"
    save_checkpoint(path, params_to_flax(build_model_from_meta(meta).state_dict()), meta)
    return path


@pytest.fixture(scope="module")
def r5_predictors():
    """JAX's and the port's ``DualGNNPredictor`` of ``artifacts/dual_gnn_r5``
    in each seed mode, made on first use (each JAX one compiles once)."""
    jparams, jmeta, _ = j_load(R5)
    tparams, tmeta, _ = load_checkpoint(R5)
    made = {}

    def get(seed_mode):
        if seed_mode not in made:
            jmodel = FlaxDualGNN(hidden_dim=jmeta["hidden"], layers=jmeta["layers"],
                                 heads=jmeta["heads"], dropout=jmeta["dropout"])
            made[seed_mode] = (
                teval.DualGNNPredictor(build_model_from_meta(tmeta), tparams,
                                       seed_mode=seed_mode, device="cpu"),
                jeval.DualGNNPredictor(jmodel, jparams, seed_mode=seed_mode),
            )
        return made[seed_mode]

    return get


@pytest.mark.parametrize("seed_mode", ["gnn", "rank1", "auto"])
def test_dual_gnn_predictor_matches_jax(r5_predictors, records, seed_mode):
    """``DualGNNPredictor`` of ``artifacts/dual_gnn_r5`` on the uniform,
    block and sparse instances at n = 16, one a call as the evaluation calls
    it, in each seed mode: u and v within atol 1e-4·max(1, max|u|) of JAX's
    predictor (the model's products sum in another order), v feasible for
    u."""
    port, ref = r5_predictors(seed_mode)
    assert port.seed_mode == seed_mode and port.device == torch.device("cpu")
    for fam in ("uniform", "block", "sparse"):
        C = records[FAMS.index(fam)]["cost"].astype(np.float32)[None]
        gu, gv = port.predict_duals(C)
        with jax.enable_x64(False):  # as the evaluation below runs it
            wu, wv = ref.predict_duals(jnp.asarray(C))
        for g, w in ((gu, wu), (gv, wv)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, err_msg=fam,
                                       atol=1e-4 * max(1.0, float(np.abs(w).max())))
        assert (C - gu.numpy()[..., :, None] - gv.numpy()[..., None, :]).min() >= 0.0


def test_dual_gnn_predictor_takes_a_state_dict_and_checks_its_mode(small_dual):
    """A state dict serves as well as the flax tree; an unknown seed mode
    raises."""
    params, meta, _ = load_checkpoint(small_dual)
    sd = params_from_flax(params)
    by_tree = teval.DualGNNPredictor(build_model_from_meta(meta), params, seed_mode="gnn",
                                     device="cpu")
    by_sd = teval.DualGNNPredictor(build_model_from_meta(meta), sd, seed_mode="gnn",
                                   device="cpu")
    C = FAMILIES["uniform"](N, np.random.default_rng(0)).astype(np.float32)
    for a, b in zip(by_tree.predict_duals(C), by_sd.predict_duals(C)):
        assert a.shape == (1, N)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError):
        teval.DualGNNPredictor(build_model_from_meta(meta), sd, seed_mode="x", device="cpu")


# ------------------------------------------------------ evaluate_pipeline


class _StubPredictor:
    """Serves fixed float64 duals, one pair a call, in order; the port
    evaluates on its ``device``."""

    device = torch.device("cpu")

    def __init__(self, duals, seed_mode):
        self._duals = list(duals)
        self.seed_mode = seed_mode

    def predict_duals(self, cost):
        u, v = self._duals.pop(0)
        return u[None], v[None]


def _stub_duals(records):
    """Per instance: the oracle u plus noise with its min-trick v; the
    rank-1 duals (so the auto posture's rank-1 win counts them); and one
    pair pushed 0.01 infeasible."""
    rng = np.random.default_rng(12)
    out = []
    for i, r in enumerate(records):
        C = r["cost"]
        if i % 3 == 1:
            u = rank1_duals(_t(C.astype(np.float32))[None])[0][0].numpy().astype(np.float64)
        else:
            u = r["u"] + rng.normal(scale=0.05, size=C.shape[0])
        v = (C - u[:, None]).min(0)
        if i == 4:
            v = v + 0.01
        out.append((u, v))
    return out


@pytest.fixture(scope="module")
def stub_metrics(records):
    """``evaluate_pipeline`` of both packages on the same injected duals,
    JAX with x64 off; timing on, one repeat."""
    duals = _stub_duals(records)
    got = teval.evaluate_pipeline(_StubPredictor(duals, "auto"), records, repeats=1)
    with jax.enable_x64(False):
        want = jeval.evaluate_pipeline(_StubPredictor(duals, "auto"), records, repeats=1)
    return got, want


def test_evaluate_pipeline_matches_jax_on_injected_duals(stub_metrics):
    """Every key of JAX's result, each equal: rates and counts exactly,
    floats (the IQR lists too) within 1e-12 relative; the timing keys are
    present in both.  The injected duals make every branch count: rank-1
    wins, one infeasible pair, the sparse family's clipped gap."""
    got, want = stub_metrics
    assert set(got) == set(want)
    for k in TIMING_KEYS:
        assert k in got and np.isfinite(got[k])
    for k, w in want.items():
        if k in TIMING_KEYS:
            continue
        g = got[k]
        if k in ("num_instances", "feasible_rate", "assist_rate", "fallback_rate",
                 "rank1_seed_win_rate"):
            assert g == w, k
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, err_msg=k)
    assert 0.0 < got["feasible_rate"] < 1.0 and 0.0 < got["rank1_seed_win_rate"] < 1.0
    assert got["presolve_gap_median"] != got["presolve_gap_clipped_median"] or \
        got["presolve_gap_mean"] != got["presolve_gap_clipped_mean"]


def test_evaluate_pipeline_runs_on_the_gpu_unless_the_predictor_says(records, monkeypatch):
    """A predictor without a ``device`` is evaluated on the GPU, as every
    entry point of the port defaults to: with no GPU it raises rather than
    fall back to the CPU."""

    class NoDevice:
        seed_mode = "gnn"

        def predict_duals(self, cost):
            raise AssertionError("the device is resolved before any predict")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.evaluate_pipeline(NoDevice(), records[:1], time_solvers=False)


@pytest.fixture(scope="module")
def one_gnn_pipelines():
    """OneGNN (``artifacts/one_gnn_default``) in hybrid mode, seed mode
    'auto', in each package."""
    tparams, tmeta, _ = load_checkpoint(ONE_GNN)
    jparams, jmeta, _ = j_load(ONE_GNN)
    jone = FlaxOneGNN(hidden=jmeta["hidden"], layers=jmeta["layers"],
                      dropout=jmeta["dropout"], topk=jmeta["topk"])
    return (WarmStartPipeline(build_model_from_meta(tmeta), tparams, mode="hybrid",
                              seed_mode="auto", device="cpu"),
            JaxPipeline(jone, jparams, mode="hybrid", seed_mode="auto"))


@pytest.mark.parametrize("arm", ["one_gnn", "dual_gnn"])
def test_evaluate_pipeline_end_to_end_matches_jax(one_gnn_pipelines, r5_predictors, records, arm):
    """The real predictors (OneGNN from ``artifacts/one_gnn_default``,
    DualGNN from ``artifacts/dual_gnn_r5``, both 'auto') on one instance of
    each family: rates equal (every pair feasible, every seeded solve
    exact); the dual errors within 1e-3 relative + 1e-6 (the duals are
    float32, summed in another order); the greedy gaps within 1e-3 relative
    + 1e-4."""
    port, ref = one_gnn_pipelines if arm == "one_gnn" else r5_predictors("auto")
    got = teval.evaluate_pipeline(port, records, time_solvers=False)
    with jax.enable_x64(False):
        want = jeval.evaluate_pipeline(ref, records, time_solvers=False)
    assert set(got) == set(want)
    for k in ("num_instances", "feasible_rate", "assist_rate", "fallback_rate"):
        assert got[k] == want[k], k
    assert got["feasible_rate"] == 1.0 and got["assist_rate"] == 1.0
    for k in ("u_mse", "v_mse", "u_mae", "u_mae_gauge", "v_mae", "u_mae_gauge_iqr"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6, err_msg=k)
    for k in ("presolve_gap_mean", "presolve_gap_median", "presolve_gap_clipped_mean",
              "presolve_gap_clipped_median", "presolve_gap_clipped_iqr"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4, err_msg=k)


# ------------------------------------------------------------------ CLIs


@pytest.fixture(scope="module")
def tiny_split(tmp_path_factory):
    """Two instances of each family at n = 12, written by the port's H5Writer."""
    from lapgnn_tpu_torch.data.h5io import H5Writer

    path = tmp_path_factory.mktemp("split") / "val.h5"
    with H5Writer(path) as w:
        for i in range(2):
            for j, f in enumerate(FAMS):
                w.append(generate_synthetic_instance(f, 12, np.random.default_rng(100 + 8 * i + j)))
    return path


def test_eval_cli_prints_the_jax_keys(tiny_split, small_dual, stub_metrics, capsys):
    """``cli.eval --device cpu`` on both kinds of checkpoint prints one JSON
    object with the keys of the JAX evaluation (timing included)."""
    _, want = stub_metrics
    dual_path = small_dual
    for ckpt, extra in ((ONE_GNN, []), (dual_path, ["--seed-mode", "gnn"])):
        eval_cli.main(["--checkpoint", str(ckpt), "--split", str(tiny_split), "--limit", "3",
                       "--device", "cpu"] + extra)
        out = json.loads(capsys.readouterr().out)
        assert set(out) == set(want) - ({"rank1_seed_win_rate"} if extra else set())
        assert out["num_instances"] == 3 and out["assist_rate"] == 1.0


def test_accuracy_ladder_cli_prints_the_jax_keys(tiny_split, small_dual, stub_metrics,
                                                 tmp_path, capsys):
    """``cli.accuracy_ladder --device cpu`` scores both models on the same
    instances, per family and overall, with the JAX CLI's keys, and writes
    the JSON it prints to ``--output``."""
    _, want = stub_metrics
    dual_path = small_dual
    out_path = tmp_path / "ladder.json"
    accuracy_ladder.main(["--one-gnn", str(ONE_GNN), "--dual-gnn", str(dual_path),
                          "--split", str(tiny_split), "--limit", "1", "--device", "cpu",
                          "--output", str(out_path)])
    text = capsys.readouterr().out
    result = json.loads(out_path.read_text())
    assert text.endswith(json.dumps(result, indent=2) + "\n")
    assert set(result) == {"one_gnn", "dual_gnn"}
    for arm in result.values():
        assert list(arm["overall"]) == LADDER_KEYS
        assert sorted(arm["per_family"]) == sorted(FAMS)
        for m in arm["per_family"].values():
            assert set(m) == set(want) - set(TIMING_KEYS)
            assert m["num_instances"] == 1 and m["assist_rate"] == 1.0
    assert accuracy_ladder.LADDER_KEYS == tuple(LADDER_KEYS)
    for line in ("one_gnn uniform: u_mae_gauge=", "dual_gnn overall: {"):
        assert line in text


def test_cli_parsers_default_to_the_gpu():
    args = eval_cli.build_parser().parse_args(["--checkpoint", "c", "--split", "s"])
    assert args.device == "cuda" and args.mode == "hybrid" and args.seed_mode == "auto"
    args = accuracy_ladder.build_parser().parse_args(["--one-gnn", "o", "--split", "a", "b"])
    assert args.device == "cuda" and args.limit == 40 and len(args.split) == 2
