"""``WarmStartPipeline`` serving a DualGNN, on the CPU.

The pipeline's DualGNN predict (``pipeline.predict_duals_fn`` of a
``DualGNN``: ``graph_features``, the model without dropout, the seed policy)
is held to the benchmark's plain reference (``lapbench/reference/dual_gnn``,
which imports nothing of the port or of JAX) and to the JAX package's
``DualGNNPredictor`` on the same weights; ``solve``, ``solve(certify=True)``,
``solve_stream`` and hybrid mode answer SciPy's optimum; ``normalize_costs``
is refused; each layer is two tracer spans under ``lapgnn.predict.model``
and each forward one ``dual_forward``.  Seeded random weights at hidden 32,
2 layers, 4 heads, and the trained ``artifacts/dual_gnn_r5``; n of 16 to 64.
"""

from pathlib import Path

import numpy as np
import pytest
import scipy.optimize
import torch

from lapbench.reference import dual_gnn as reference
from lapgnn_tpu_torch import tracing
from lapgnn_tpu_torch.data.generators import FAMILIES
from lapgnn_tpu_torch.evaluation import DualGNNPredictor
from lapgnn_tpu_torch.ops.sinkhorn import auto_select_seed
from lapgnn_tpu_torch.pipeline import WarmStartPipeline
from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint, params_to_flax

R5 = Path(__file__).resolve().parent.parent / "artifacts" / "dual_gnn_r5"
META = {"architecture": "dual_gnn", "hidden": 32, "layers": 2, "heads": 4, "dropout": 0.1,
        "node_feat_dim": 14, "edge_feat_dim": 10}
SERVED = ["uniform", "noisy_linear", "sparse", "tie"]  # the serving benchmark's families
# the sparse family is left out where the model's u is compared: its scaled-cost
# channel reaches about -1e15 and saturates the attention, so float32 rounding
# alone sets u (the two orders of summation below differ by 7-30% there)
CONDITIONED = ["uniform", "noisy_linear", "tie", "metric", "low_rank", "block"]


def _cost(fam, n, seed):
    return FAMILIES[fam](n, np.random.default_rng(seed)).astype(np.float32)


def _optimum(C):
    C64 = np.asarray(C, np.float64)
    r, c = scipy.optimize.linear_sum_assignment(C64)
    return float(C64[r, c].sum())


def _flat(params):
    """The flax tree as the reference reads it: {"a/b": float32 tensor}."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                out[prefix + k] = torch.tensor(np.asarray(v), dtype=torch.float32)

    walk(params["params"], "")
    return out


@pytest.fixture(scope="module")
def params():
    torch.manual_seed(20)
    return params_to_flax(build_model_from_meta(META).state_dict())


def _pipe(params, meta=META, **kw):
    kw.setdefault("normalize_costs", False)
    return WarmStartPipeline(build_model_from_meta(meta), params, device="cpu", **kw)


def _reference_u(params, C, meta=META):
    row, col, edge = reference.graph_features(torch.from_numpy(C)[None])
    u, _ = reference.forward(_flat(params), row, col, edge, meta["layers"], meta["heads"],
                             meta["dropout"], None)
    return u


@pytest.mark.parametrize("n", [16, 33, 64])
@pytest.mark.parametrize("fam", CONDITIONED)
def test_predict_matches_the_plain_reference(params, fam, n):
    """The model's u (seed mode 'gnn', v the min-trick's) and the served
    pair under 'auto' (the reference's u through the same seed policy)
    within atol 1e-5 * max(1, max|u|): the port takes the two edge terms as
    one block-diagonal product and the reference as two einsums, so their
    float32 sums run in other orders (measured at most 7e-6 of max|u|, 3e-7
    absolute)."""
    C = _cost(fam, n, 100 + n)
    u_ref = _reference_u(params, C)
    tol = 1e-5 * max(1.0, float(u_ref.abs().max()))
    u, v = _pipe(params, seed_mode="gnn").predict_duals(C)
    torch.testing.assert_close(u, u_ref, rtol=0, atol=tol)
    torch.testing.assert_close(v, (torch.from_numpy(C)[None] - u[..., :, None]).amin(-2),
                               rtol=0, atol=0)
    served = _pipe(params).predict_duals(C)
    want = auto_select_seed(torch.from_numpy(C)[None], u_ref)
    for got, w in zip(served, want):
        torch.testing.assert_close(got, w, rtol=0, atol=1e-5 * max(1.0, float(w.abs().max())))


@pytest.fixture(scope="module")
def jax_predictor(params):
    jax = pytest.importorskip("jax")
    from lapgnn_tpu import evaluation as jeval
    from lapgnn_tpu.models import DualGNN as FlaxDualGNN

    model = FlaxDualGNN(hidden_dim=META["hidden"], layers=META["layers"], heads=META["heads"],
                        dropout=META["dropout"])
    return jax, jeval.DualGNNPredictor(model, params, seed_mode="auto")


@pytest.mark.parametrize("fam", [f for f in SERVED if f in CONDITIONED])
def test_predict_matches_jax_predictor(params, jax_predictor, fam):
    """The served pair against JAX's ``DualGNNPredictor(seed_mode="auto")``
    on the same weights (``train.convert``), n = 32, on the serving
    families but the sparse one (see ``CONDITIONED``), within atol
    1e-4 * max(1, max|u|): the two packages' products and reductions sum in
    other orders, and the Sinkhorn refinement carries the difference
    through its ladder (the tolerance of the port's own r5 predictor test);
    the pair is dual-feasible."""
    jax, ref = jax_predictor
    C = _cost(fam, 32, 7 + SERVED.index(fam))
    got = _pipe(params).predict_duals(C)
    with jax.enable_x64(False):
        want = ref.predict_duals(jax.numpy.asarray(C[None]))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, err_msg=fam,
                                   atol=1e-4 * max(1.0, float(np.abs(w).max())))
    u, v = (t.numpy()[0] for t in got)
    assert (C - u[:, None] - v[None, :]).min() >= 0.0


def test_predictor_is_the_pipelines_predict(params):
    """``DualGNNPredictor`` serves the pipeline's own predict: the same
    pair, bit for bit, in every seed mode."""
    C = _cost("noisy_linear", 24, 3)
    for mode in ("gnn", "rank1", "auto"):
        a = DualGNNPredictor(build_model_from_meta(META), params, seed_mode=mode,
                             device="cpu").predict_duals(C)
        b = _pipe(params, seed_mode=mode).predict_duals(C)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.fixture(scope="module")
def r5():
    params, meta, _ = load_checkpoint(R5)
    return params, meta


@pytest.mark.parametrize("weights", ["random", "r5"])
@pytest.mark.parametrize("fam", SERVED)
def test_every_call_answers_the_optimum(params, r5, weights, fam):
    """``solve``, ``solve(certify=True)``, ``solve_stream`` (with and
    without the certificate) and hybrid mode on one instance at n = 48.
    The certified and the hybrid answers are float64-exact: SciPy's optimum
    to 1e-12 relative (``certify_tol`` 1e-12, as the OneGNN device tests).
    The uncertified float32 device solve is exact up to its tightness
    tolerance: at most 1e-5 a row above the optimum (``default_tight_eps``,
    the serving benchmark's ``opt_gap``)."""
    p, meta = (params, META) if weights == "random" else r5
    C = _cost(fam, 48, 30 + SERVED.index(fam))
    opt = _optimum(C)
    device = _pipe(p, meta, certify_tol=1e-12)
    hybrid = _pipe(p, meta, mode="hybrid")
    plain = [device.solve(C), device.solve_stream([C])[0]]
    exact = [device.solve(C, certify=True), device.solve_stream([C], certify=True)[0],
             hybrid.solve(C), hybrid.solve(C, certify=True)]
    for out in plain + exact:
        x = out["col_of_row"][0]
        assert np.array_equal(np.sort(x), np.arange(48))
        cost = float(C.astype(np.float64)[np.arange(48), x].sum())
        assert cost - opt <= 1e-5 * 48
    for out in exact:
        assert out.get("certified", np.ones(1, bool)).all()  # hybrid's uncertified call has none
        assert abs(out["cost"][0] - opt) <= 1e-12 * max(1.0, abs(opt))


def test_normalize_costs_is_refused(params):
    """A DualGNN scales the raw costs itself; asking the pipeline to
    normalise them raises rather than being ignored (the constructor's
    default is True, so a DualGNN must pass False)."""
    with pytest.raises(ValueError, match="normalize_costs"):
        _pipe(params, normalize_costs=True)
    with pytest.raises(ValueError, match="normalize_costs"):
        WarmStartPipeline(build_model_from_meta(META), params, device="cpu")


@pytest.mark.parametrize("how", ["record", "profiler"])
def test_layer_spans_and_the_forward_counter(params, how):
    """Under the tracer a call's ``lapgnn.predict.model`` holds each
    layer's ``lapgnn.dual.edge`` then ``lapgnn.dual.attention``, one each a
    layer, and the forward adds one ``dual_forward`` a call; off, nothing
    records and the counter counts all the same."""
    pipe = _pipe(params)
    C = _cost("uniform", 20, 5)
    tracing.take()
    before = tracing.counters().get("dual_forward", 0)
    if how == "record":
        with tracing.record():
            pipe.solve(C)
            pipe.solve(C)
    else:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            pipe.solve(C)
            pipe.solve(C)
    assert tracing.counters()["dual_forward"] == before + 2
    spans = tracing.take()
    by_id = {s.id: s for s in spans}
    models = [s for s in spans if s.name == "lapgnn.predict.model"]
    assert len(models) == 2
    for model in models:
        assert by_id[model.parent].name == "lapgnn.predict"
        inner = sorted((s for s in spans if s.parent == model.id), key=lambda s: s.start_ns)
        assert [s.name for s in inner] == ["lapgnn.dual.edge", "lapgnn.dual.attention"] * 2
        assert all(s.request == model.request for s in inner)
        assert model.counts("dual_forward") == 1
    pipe.solve(C)
    assert tracing.take() == []
    assert tracing.counters()["dual_forward"] == before + 3
