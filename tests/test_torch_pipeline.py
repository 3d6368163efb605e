"""The port's warm-start pipeline against the JAX pipeline, in hybrid and in
device mode, plus the port's hygiene: no JAX import, no silent fall back to
the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.optimize
import torch

from lapgnn_tpu.data.generators import FAMILIES
from lapgnn_tpu.models import OneGNN as FlaxOneGNN
from lapgnn_tpu.pipeline import WarmStartPipeline as JaxPipeline
from lapgnn_tpu.solver.native import repair_duals_native as j_repair
from lapgnn_tpu.solver.verification import certify_assignment as j_certify
from lapgnn_tpu.train.checkpoint import load_checkpoint as j_load
from lapgnn_tpu_torch.pipeline import WarmStartPipeline, predict_duals_fn
from lapgnn_tpu_torch.solver.native import (
    lapjv_native,
    lapjv_seeded_native,
    repair_duals_native,
)
from lapgnn_tpu_torch.solver.verification import certify_assignment
from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint, params_from_flax

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "artifacts" / "one_gnn_default"
SLICE_FAMS = ["uniform", "noisy_linear", "sparse", "tie"]


def _cost(fam, n, seed):
    return FAMILIES[fam](n, np.random.default_rng(seed)).astype(np.float32)


def _scipy_cost(C):
    C64 = np.asarray(C, np.float64)
    r, c = scipy.optimize.linear_sum_assignment(C64)
    return float(C64[r, c].sum())


@pytest.fixture(scope="module")
def pipelines():
    params, meta, _ = load_checkpoint(CKPT)
    port = WarmStartPipeline(
        build_model_from_meta(meta), params, mode="hybrid", seed_mode="auto",
        normalize_costs=True, device="cpu",
    )
    jparams, jmeta, _ = j_load(CKPT)
    jmodel = FlaxOneGNN(hidden=jmeta["hidden"], layers=jmeta["layers"],
                        dropout=jmeta["dropout"], topk=jmeta["topk"])
    ref = JaxPipeline(jmodel, jparams, mode="hybrid", seed_mode="auto",
                      normalize_costs=True)
    return port, ref


@pytest.mark.parametrize("fam", SLICE_FAMS)
def test_hybrid_slice_matches_jax(pipelines, fam):
    """Optimal costs identical to JAX's and to SciPy's (1e-12 relative);
    the seed's dual objective sum(u)+sum(v) within 1e-4 relative (the
    three-way seed argmax may take another candidate on a near-tie, so u and
    v are not compared element by element)."""
    port, ref = pipelines
    C = _cost(fam, 64, seed=100 + SLICE_FAMS.index(fam))
    got = port.solve(C, certify=True)
    want = ref.solve(C, certify=True)
    opt = _scipy_cost(C)
    assert got["cost"][0] == want["cost"][0]
    assert abs(got["cost"][0] - opt) <= 1e-12 * max(1.0, abs(opt))
    for key in ("certified", "gap_bound", "repaired", "polished", "polish_ms"):
        np.testing.assert_array_equal(got[key], want[key])
    # any optimal duals certify any optimal assignment
    _, _, _, _, v_opt = lapjv_native(C.astype(np.float64), return_duals=True)
    assert certify_assignment(C, got["col_of_row"][0], v_opt)[0]

    u, v = port.predict_duals(C)
    ju, jv = ref.predict_duals(C[None])
    tobj = float(u.sum() + v.sum())
    jobj = float(np.asarray(ju).sum() + np.asarray(jv).sum())
    assert abs(tobj - jobj) <= 1e-4 * max(1.0, abs(jobj))
    red = C - u[0].numpy()[:, None] - v[0].numpy()[None, :]
    assert red.min() >= 0.0  # the seed is feasible


@pytest.fixture(scope="module")
def device_pipelines():
    params, meta, _ = load_checkpoint(CKPT)
    port = WarmStartPipeline(build_model_from_meta(meta), params, device="cpu")
    jparams, jmeta, _ = j_load(CKPT)
    jmodel = FlaxOneGNN(hidden=jmeta["hidden"], layers=jmeta["layers"],
                        dropout=jmeta["dropout"], topk=jmeta["topk"])
    ref = JaxPipeline(jmodel, jparams)
    assert port.mode == ref.mode == "device"
    return port, ref


CERT_KEYS = ("certified", "repaired", "polished", "used_fallback")


@pytest.mark.parametrize("certify_tol", [1e-6, 1e-12])
@pytest.mark.parametrize("fam", SLICE_FAMS)
def test_device_slice_matches_jax(device_pipelines, fam, certify_tol):
    """The default device mode (float32 solve on the device, float64
    certificate on the host) against the JAX one: the same assignment,
    cost and certificate flags.  With certify_tol 1e-12 the certificate
    holds every result to SciPy's optimum (1e-12 relative): the dual repair
    or the polish proves it.  The default 1e-6 admits per-row violations up
    to 1e-6, a gap up to n * 1e-6: on the tie family (optimum ~1e-5, jitter
    1e-6) both ports certify a costlier assignment, alike."""
    port, ref = device_pipelines
    port.certify_tol = ref.certify_tol = certify_tol
    C = _cost(fam, 64, seed=100 + SLICE_FAMS.index(fam))
    got = port.solve(C, certify=True)
    want = ref.solve(C, certify=True)
    assert "routed_host" not in got
    np.testing.assert_array_equal(got["col_of_row"], want["col_of_row"])
    assert got["cost"][0] == want["cost"][0]
    for key in CERT_KEYS:
        np.testing.assert_array_equal(got[key], want[key])
    assert got["certified"].all()
    if certify_tol == 1e-12:
        opt = _scipy_cost(C)
        assert abs(got["cost"][0] - opt) <= 1e-12 * max(1.0, abs(opt))
    (stats,) = port.last_solve_stats
    assert stats.arr_rounds >= 1 and stats.host_syncs >= stats.arr_rounds


@pytest.mark.parametrize("perturb", [False, True])
def test_repair_duals_native_matches_jax(perturb):
    """On optimal duals and on duals pushed off feasibility, the port's dual
    repair returns the JAX binding's duals and minimum reduced cost."""
    C = _cost("uniform", 60, 11).astype(np.float64)
    x, _, _, _, v = lapjv_native(C, return_duals=True)
    if perturb:
        v = v + np.random.default_rng(12).normal(0, 1e-3, 60)
    got = repair_duals_native(C, x, v)
    want = j_repair(C, x, v)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[1] >= -1e-12
    assert certify_assignment(C, x, got[0], tol=1e-12)[0]
    bad = x.copy()
    bad[[0, 1]] = bad[[1, 0]]
    if _scipy_cost(C) < C[np.arange(60), bad].sum():
        # a suboptimal assignment has a negative cycle: the budget runs out
        assert repair_duals_native(C, bad, v, max_scans=600) is None
    with pytest.raises(ValueError):
        repair_duals_native(C, x[:-1], v)


@pytest.mark.parametrize("mode", ["device", "hybrid"])
def test_route_on_the_cpu_device(mode):
    """route="auto" never routes on the CPU device (the device is the host);
    route="host" always routes a host array."""
    params, meta, _ = load_checkpoint(CKPT)
    C = _cost("uniform", 40, 8)
    for route, routed in (("auto", False), ("host", True)):
        pipe = WarmStartPipeline(build_model_from_meta(meta), params, mode=mode,
                                 route=route, device="cpu")
        assert pipe._route_to_host(40) is routed
        out = pipe.solve(C, certify=True)
        assert ("routed_host" in out) is routed
        assert abs(out["cost"][0] - _scipy_cost(C)) <= 1e-12 * max(1.0, _scipy_cost(C))


@pytest.mark.parametrize("seed_mode", ["gnn", "rank1"])
def test_predict_seed_modes_match_jax(seed_mode):
    """'gnn' and 'rank1' seeds: (u, v) element by element (no selection
    step), atol 1e-4 on a [0, 1]-scale instance."""
    from lapgnn_tpu.pipeline import predict_duals_fn as j_predict_fn

    params, meta, _ = load_checkpoint(CKPT)
    jparams, _, _ = j_load(CKPT)
    model = build_model_from_meta(meta).eval()
    model.load_state_dict(params_from_flax(params))
    jmodel = FlaxOneGNN(hidden=192, layers=4, dropout=0.0, topk=16)
    C = _cost("uniform", 48, seed=7)[None]
    ju, jv = j_predict_fn(jmodel, True, True, seed_mode)(jparams, C)
    tu, tv = predict_duals_fn(model, True, True, seed_mode)(torch.from_numpy(C))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)


def test_batched_solve_and_host_route():
    params, meta, _ = load_checkpoint(CKPT)
    C = np.stack([_cost("uniform", 40, 8), _cost("metric", 40, 9)])
    for route in ("auto", "host"):
        pipe = WarmStartPipeline(build_model_from_meta(meta), params, mode="hybrid",
                                 route=route, device="cpu")
        out = pipe.solve(torch.from_numpy(C), certify=True)
        assert out["col_of_row"].shape == (2, 40)
        for b in range(2):
            assert abs(out["cost"][b] - _scipy_cost(C[b])) <= 1e-12 * max(1.0, _scipy_cost(C[b]))
        assert out["certified"].all()


@pytest.mark.parametrize("mode", ["hybrid", "device"])
def test_host_route_answers_with_scipy_when_the_native_solver_fails(monkeypatch, mode):
    """With the native library unavailable (no compiler in hybrid mode, a
    library that does not load in device mode), ``route="host"`` answers
    every instance of the batch with SciPy's optimum, as the JAX pipeline
    does, instead of raising."""
    from lapgnn_tpu_torch.solver import native

    error = native.NativeSolveError if mode == "hybrid" else OSError

    def unavailable():
        raise error("native library unavailable")

    monkeypatch.setattr(native, "_lib", unavailable)
    with pytest.raises(error):
        lapjv_native(np.eye(3))
    params, meta, _ = load_checkpoint(CKPT)
    C = np.stack([_cost("uniform", 40, 8), _cost("tie", 40, 9), _cost("sparse", 40, 10)])
    pipe = WarmStartPipeline(build_model_from_meta(meta), params, mode=mode, route="host",
                             device="cpu")
    out = pipe.solve(torch.from_numpy(C), certify=True)
    assert out["routed_host"].all() and out["certified"].all()
    for b in range(3):
        want = _scipy_cost(C[b])
        assert abs(out["cost"][b] - want) <= 1e-12 * max(1.0, want)
        _, x = scipy.optimize.linear_sum_assignment(C[b].astype(np.float64))
        np.testing.assert_array_equal(out["col_of_row"][b], x)


def test_native_solvers_and_certificate_match_jax():
    C = _cost("tie", 50, 10).astype(np.float64)
    x, y, c, u, v = lapjv_native(C, return_duals=True)
    assert abs(c - _scipy_cost(C)) <= 1e-12
    np.testing.assert_array_equal(y[x], np.arange(50))
    for gate in ("density", "free_rows", "both", "never"):
        xs, _, cs, info = lapjv_seeded_native(C, u * 0.9, v, gate=gate, return_info=True)
        assert abs(cs - c) <= 1e-12
    assert certify_assignment(C, x, v) == j_certify(C, x, v)
    bad = x.copy()
    bad[0] = bad[1]
    assert certify_assignment(C, bad, v) == j_certify(C, bad, v) == (False, float("inf"), float("inf"))
    v_bad = v.copy()
    v_bad[0] += 1.0  # raises column 0 above its feasible value
    assert certify_assignment(C, x, v_bad) == j_certify(C, x, v_bad)
    assert certify_assignment(C, x, v_bad)[0] is False
    with pytest.raises(ValueError):
        lapjv_seeded_native(C, u[:-1], v)


def test_constructor_validation_and_unported_modes():
    params, meta, _ = load_checkpoint(CKPT)

    def make(**kw):
        return WarmStartPipeline(build_model_from_meta(meta), params, device="cpu", **kw)

    assert make().mode == "device"  # the JAX default
    assert make(mode="device").mode == "device"
    for enc in ("float32", "bfloat16", "float16", "uint16", "topk16"):
        assert make(transfer_dtype=enc).transfer_dtype == enc
    for enc in ("float32", "bfloat16", "float16"):
        assert make(mode="hybrid", transfer_dtype=enc).mode == "hybrid"
    for enc in ("uint16", "topk16"):  # their decode runs in device mode only
        with pytest.raises(ValueError, match="requires mode='device'"):
            make(mode="hybrid", transfer_dtype=enc)
    with pytest.raises(ValueError, match="requires mode='device'"):
        make(mode="hybrid").solve_stream([np.zeros((4, 4))])
    for bad in ({"mode": "x"}, {"route": "x"}, {"gate": "x"}, {"transfer_dtype": "int8"}):
        with pytest.raises(ValueError):
            make(**bad)
    with pytest.raises(ValueError):
        make().solve(np.zeros((3, 4), np.float32))  # the device solver is square-only
    with pytest.raises(ValueError):
        predict_duals_fn(build_model_from_meta(meta), seed_mode="x")


def test_default_device_raises_without_gpu():
    from lapgnn_tpu_torch import resolve_device

    if torch.cuda.is_available():
        pytest.skip("checks the GPU-less path")

    params, meta, _ = load_checkpoint(CKPT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WarmStartPipeline(build_model_from_meta(meta), params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WarmStartPipeline(build_model_from_meta(meta), params, mode="hybrid")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_no_jax():
    code = (
        "import sys, lapgnn_tpu_torch, lapgnn_tpu_torch.pipeline, lapgnn_tpu_torch.ops.cuda._lib\n"
        "import lapgnn_tpu_torch.solver.native, lapgnn_tpu_torch.solver.verification\n"
        "import lapgnn_tpu_torch.solver.jv, lapgnn_tpu_torch.solver.seeded\n"
        "import lapgnn_tpu_torch.ops.cuda, lapgnn_tpu_torch.ops.cuda.twomin\n"
        "import lapgnn_tpu_torch.train, lapgnn_tpu_torch.data.generators\n"
        "import lapgnn_tpu_torch.evaluation, lapgnn_tpu_torch.models.dual_gnn\n"
        "import lapgnn_tpu_torch.ops.padding, lapgnn_tpu_torch.data.h5io\n"
        "import lapgnn_tpu_torch.cli.eval, lapgnn_tpu_torch.cli.accuracy_ladder\n"
        "import lapgnn_tpu_torch.train.dual_trainer, lapgnn_tpu_torch.data.splits\n"
        "import lapgnn_tpu_torch.data.processors, lapgnn_tpu_torch.cli.generate_dataset\n"
        "import lapgnn_tpu_torch.cli.regenerate_assignments, lapgnn_tpu_torch.cli.train_one_gnn\n"
        "import lapgnn_tpu_torch.cli.train_progressive, lapgnn_tpu_torch.cli.train_dual_gnn\n"
        "import lapgnn_tpu_torch.solver.api, lapgnn_tpu_torch.solver.lap_compat\n"
        "import lapgnn_tpu_torch.solver.seed_baselines, lapgnn_tpu_torch.solver.py_sparse\n"
        "import lapgnn_tpu_torch.bench, lapgnn_tpu_torch.bench.regression, lapgnn_tpu_torch.utils\n"
        "import lapgnn_tpu_torch.cli.benchmark, lapgnn_tpu_torch.cli.main_benchmark\n"
        "import lapgnn_tpu_torch.cli.profile_pipeline, lapgnn_tpu_torch.cli.benchmark_by_type\n"
        "import lapgnn_tpu_torch.cli.comprehensive_benchmark\n"
        "import lapgnn_tpu_torch.cli.large_scale_benchmark\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'msgpack'))"
        " or m == 'lapgnn_tpu' or m.startswith('lapgnn_tpu.')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_name_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|msgpack|lapgnn_tpu)(\.|\s|$)", re.MULTILINE
    )
    files = sorted((ROOT / "lapgnn_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        hits = pattern.findall(f.read_text())
        assert not hits, f"{f}: {hits}"
