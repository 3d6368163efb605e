"""The port's benchmark and profiling layer against the JAX package's, on the
CPU (``device="cpu"`` / ``--device cpu``).

``time_rigorous`` and ``BenchmarkLogger`` keep JAX's semantics (warmup
errors swallowed, a failed repeat marks the measurement failed, ``repeats <
1`` raises; the same files, keys and CSV columns).  ``run_regression`` (with
and without the device solve), ``run_real`` and ``profile_pipeline`` return
JAX's keys.  The six benchmark CLIs run in process on one tiny OneGNN
checkpoint (hidden 16, one layer, random weights from a seed), the JAX CLI
and the port's with the same arguments: the same summary keys, the same
per-instance costs (host costs equal; device-mode float32 costs within 64
ulp of the terms' magnitude, torch and XLA summing in another order), and
every assignment the port's pipeline returns optimal for the float64
instance to 1e-12 relative.
"""

import contextlib
import csv
import io
import json
import time
from pathlib import Path

import numpy as np
import pytest
import scipy.optimize
import torch

from lapgnn_tpu.bench import harness as jharness
from lapgnn_tpu.bench import logging_system as jlogging
from lapgnn_tpu.bench import regression as jregression
from lapgnn_tpu.cli import benchmark as j_benchmark
from lapgnn_tpu.cli import benchmark_by_type as j_by_type
from lapgnn_tpu.cli import comprehensive_benchmark as j_comprehensive
from lapgnn_tpu.cli import large_scale_benchmark as j_large
from lapgnn_tpu.cli import main_benchmark as j_main
from lapgnn_tpu.cli import profile_pipeline as j_profile
from lapgnn_tpu_torch import pipeline as tpipeline
from lapgnn_tpu_torch.bench import harness, logging_system, regression
from lapgnn_tpu_torch.cli import benchmark, benchmark_by_type, comprehensive_benchmark
from lapgnn_tpu_torch.cli import large_scale_benchmark, main_benchmark, profile_pipeline
from lapgnn_tpu_torch.data import generators as tgenerators
from lapgnn_tpu_torch.train import build_model_from_meta, params_to_flax, save_checkpoint
from lapgnn_tpu_torch.utils import profiling

TINY_META = {"architecture": "one_gnn", "hidden": 16, "layers": 1, "dropout": 0.0, "topk": 4,
             "use_cost_refinement": True, "row_feat_dim": 21}
N = 16
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench") / "one"
    torch.manual_seed(3)
    model = build_model_from_meta(TINY_META)
    save_checkpoint(out, params_to_flax(model.state_dict()), TINY_META)
    return out


# ---------------------------------------------------------------- harness


class _Flaky:
    """Raises on the calls listed in ``fail`` (0-based), else returns the
    call's index."""

    def __init__(self, fail):
        self.fail, self.calls = set(fail), 0

    def __call__(self):
        k = self.calls
        self.calls += 1
        if k in self.fail:
            raise RuntimeError(f"call {k}")
        return k


@pytest.mark.parametrize("time_rigorous", [harness.time_rigorous, jharness.time_rigorous])
def test_time_rigorous_semantics(time_rigorous):
    ok = time_rigorous(_Flaky({0, 1}), warmups=2, repeats=3)  # warmup errors swallowed
    assert ok["success"] and ok["result"] == 4 and ok["repeats"] == 3
    assert set(ok) == {"success", "median", "mean", "std", "min", "max", "repeats", "result"}
    assert ok["min"] <= ok["median"] <= ok["max"]
    bad = time_rigorous(_Flaky({3}), warmups=1, repeats=4)  # a failed repeat
    assert bad == {"success": False, "error": "call 3"}
    one = time_rigorous(lambda: 1, warmups=0, repeats=1)
    assert one["std"] == 0.0
    blocked = []
    time_rigorous(lambda: 7, warmups=1, repeats=2, block=blocked.append)
    assert blocked == [7, 7, 7]
    with pytest.raises(ValueError, match="repeats"):
        time_rigorous(lambda: 1, repeats=0)


def test_time_rigorous_keys_match_jax():
    got = harness.time_rigorous(lambda: 1, warmups=1, repeats=3)
    want = jharness.time_rigorous(lambda: 1, warmups=1, repeats=3)
    assert set(got) == set(want)


def test_synchronize_block_takes_any_nesting_on_the_cpu():
    t = torch.ones(3)
    for out in (t, (t, [t]), {"a": t, "b": (1, t)}, None, np.ones(2)):
        harness.synchronize_block(out)
    assert list(harness._tensors({"a": t, "b": [t, 3]})) == [t, t]


# ---------------------------------------------------------------- logger


def _drive_logger(cls, root):
    lg = cls("exp", root=root)
    lg.log_result("scipy", "uniform", 16, {"median": 2.0, "mean": 2.0, "std": 0.0,
                                           "min": 2.0, "max": 2.0}, cost=1.5)
    lg.log_result("lap", "uniform", 16, {"median": 1.0}, speedup=2.0, notes="x")
    lg.log_result("broken", "uniform", 16, {"success": False})
    cmp = lg.log_comparison("scipy", "uniform", 16)
    none = lg.log_comparison("missing", "uniform", 16)
    path = lg.finalize({"mean_speedup": 2.0})
    return lg, cmp, none, path


def test_benchmark_logger_writes_what_jax_writes(tmp_path):
    got, g_cmp, g_none, g_path = _drive_logger(logging_system.BenchmarkLogger, tmp_path / "t")
    want, w_cmp, w_none, w_path = _drive_logger(jlogging.BenchmarkLogger, tmp_path / "j")
    assert logging_system.CSV_HEADER == jlogging.CSV_HEADER
    assert g_cmp == w_cmp == {"scipy": 1.0, "lap": 2.0} and g_none == w_none == {}

    def files(root, lg):
        return sorted(str(p.relative_to(root)).replace(lg.exp_id, "ID")
                      for p in root.rglob("*") if p.is_file())

    assert files(tmp_path / "t", got) == files(tmp_path / "j", want)
    rows = []
    for lg in (got, want):
        with lg._csv_path.open() as f:
            r = list(csv.reader(f))
        assert r[0] == jlogging.CSV_HEADER
        rows.append([row[1:] for row in r[1:]])  # all but the timestamp
    assert rows[0] == rows[1]
    g_meta, w_meta = json.loads(g_path.read_text()), json.loads(w_path.read_text())
    assert set(g_meta) == set(w_meta)
    for k in ("experiment", "num_rows", "summary"):
        assert g_meta[k] == w_meta[k]
    assert [{k: v for k, v in r.items() if k != "timestamp"} for r in g_meta["rows"]] == \
        [{k: v for k, v in r.items() if k != "timestamp"} for r in w_meta["rows"]]
    # the environment names torch, CUDA and the device where JAX names jax,
    # flax and optax
    g_env, w_env = g_meta["environment"], w_meta["environment"]
    assert set(g_env) == set(w_env) | {"device"}
    assert set(g_env["versions"]) == {"python", "numpy", "scipy", "torch", "cuda"}
    assert g_env["versions"]["torch"] == torch.__version__
    assert g_env["device"] == ("cpu" if not torch.cuda.is_available()
                               else torch.cuda.get_device_name(0))
    for sub in ("summaries", "detailed"):
        g_txt = next((tmp_path / "t" / sub).iterdir()).read_text().splitlines()
        w_txt = next((tmp_path / "j" / sub).iterdir()).read_text().splitlines()
        assert len(g_txt) == len(w_txt)
    assert (logging_system.BenchmarkLogger.list_experiments(tmp_path / "t") == [got.exp_id])
    assert (logging_system.BenchmarkLogger.get_latest_experiment(tmp_path / "t")["id"]
            == got.exp_id)
    assert logging_system.BenchmarkLogger.list_experiments(tmp_path / "none") == []
    assert logging_system.BenchmarkLogger.get_latest_experiment(tmp_path / "none") is None


# ---------------------------------------------------------------- regression


@pytest.mark.parametrize("include_device", [False, True])
def test_run_regression_keys_match_jax(include_device):
    kw = dict(sizes=[N], families=["uniform", "sparse"], repeats=1, seed=2,
              include_device=include_device)
    got = regression.run_regression(device="cpu", **kw)
    want = jregression.run_regression(**kw)
    assert list(got) == list(want)
    for cell in got:
        assert list(got[cell]) == list(want[cell])
        assert all(isinstance(v, float) and v >= 0 for v in got[cell].values())


def test_run_real_matches_jax():
    real = [str(p) for p in sorted((Path(__file__).resolve().parent.parent / "data" / "real").glob("*"))]
    got = regression.run_real(real, repeats=1)
    want = jregression.run_real(real, repeats=1)
    assert list(got) == list(want)
    for name in got:
        assert list(got[name]) == list(want[name])
        assert (got[name]["n"], got[name]["source"]) == (want[name]["n"], want[name]["source"])


def test_regression_main_writes_its_json(tmp_path, capsys):
    out = tmp_path / "reg.json"
    res = regression.main(["--sizes", "12", "--families", "uniform", "--repeats", "1",
                           "--real-files", "--output", str(out)])
    assert json.loads(out.read_text()) == res and list(res) == ["uniform_12"]
    assert json.loads(capsys.readouterr().out) == res


# ---------------------------------------------------------------- profiling


@pytest.fixture(scope="module")
def pipes(ckpt):
    from lapgnn_tpu.pipeline import WarmStartPipeline as JPipe
    from lapgnn_tpu.train.checkpoint import build_model_from_meta as j_build
    from lapgnn_tpu.train.checkpoint import load_checkpoint as j_load
    from lapgnn_tpu_torch.train import load_checkpoint

    params, meta, _ = load_checkpoint(ckpt)
    jparams, jmeta, _ = j_load(ckpt)
    out = {}
    for mode in ("device", "hybrid"):
        out[mode] = (
            tpipeline.WarmStartPipeline(build_model_from_meta(meta), params, mode=mode,
                                        route="device", device="cpu"),
            JPipe(j_build(jmeta), jparams, mode=mode, route="device"),
        )
    return out


@pytest.mark.parametrize("mode", ["device", "hybrid"])
def test_profile_pipeline_keys_match_jax(pipes, mode):
    from lapgnn_tpu.utils.profiling import profile_pipeline as j_profile_pipeline

    port, ref = pipes[mode]
    C = tgenerators.FAMILIES["uniform"](N, np.random.default_rng(4))
    got = profiling.profile_pipeline(port, C, repeats=2)
    want = j_profile_pipeline(ref, C, repeats=2)
    assert list(got) == list(want)
    assert all(v >= 0 for v in got.values())
    stages = [k for k in got if not k.endswith("_ms")]
    assert got["total_pipeline_ms"] == pytest.approx(sum(got[k] for k in stages))


def test_profile_pipeline_times_the_pipelines_device_solver(pipes, monkeypatch):
    """In device mode the seeded_solve stage runs ``lapjv_seeded_batch``
    with the pipeline's eps and gate: the batched form of the solver that
    ``solve`` runs, with the same answer."""
    from lapgnn_tpu_torch.solver.seeded import lapjv_seeded_batch, lapjv_seeded_single

    port = pipes["device"][0]
    calls = []

    def batch(C, u, v, **kw):
        res = lapjv_seeded_batch(C, u, v, **kw)
        calls.append((C, u, v, kw, res))
        return res

    monkeypatch.setattr(profiling, "lapjv_seeded_batch", batch)
    C = tgenerators.FAMILIES["uniform"](N, np.random.default_rng(5))
    profiling.profile_pipeline(port, C, repeats=1)
    assert len(calls) == 2
    Cd, u, v, kw, res = calls[-1]
    assert kw == {"eps": port.eps, "gate": port.gate}
    one = lapjv_seeded_single(Cd[0], u[0], v[0], eps=port.eps, gate=port.gate)
    assert torch.equal(res.col_of_row[0], one.col_of_row)
    assert torch.equal(res.v[0], one.v)
    assert torch.equal(res.col_of_row, torch.from_numpy(port.solve(C)["col_of_row"]))


def test_stage_profiler_and_trace(tmp_path):
    prof = profiling.StageProfiler()
    for _ in range(3):
        with prof.stage("a") as box:
            box["out"] = {"x": torch.ones(4)}
        with prof.stage("b"):
            time.sleep(0.002)
    summary = prof.summary_ms()
    assert set(summary) == {"a", "b"} and len(prof.stages["a"]) == 3
    assert summary["b"] >= 2.0
    with profiling.trace(tmp_path / "tr") as d:
        torch.ones(8).sum()
    assert d == tmp_path / "tr"
    assert json.loads((d / "trace.json").read_text())


# ---------------------------------------------------------------- the six CLIs


def _args(logs):
    ck = "{ckpt}"
    return {
        "benchmark": ["--checkpoint", ck, "--sizes", str(N), "--families", "uniform", "sparse",
                      "--mode", "device", "--quick", "--logs", logs],
        "profile_pipeline": ["--checkpoint", ck, "--families", "uniform", "sparse",
                             "--size", str(N), "--mode", "device", "--repeats", "1"],
        "benchmark_by_type": ["--checkpoint", ck, "--families", "uniform", "sparse",
                              "--size", str(N), "--instances", "1", "--repeats", "1",
                              "--logs", logs],
        "comprehensive_benchmark": ["--checkpoint", ck, "--families", "uniform", "sparse",
                                    "--sizes", str(N), "--instances", "1", "--repeats", "1",
                                    "--no-plots", "--out", logs],
        "large_scale_benchmark": ["--checkpoint", ck, "--sizes", str(N), "24", "--instances",
                                  "1", "--repeats", "1", "--mode", "device", "--logs", logs],
        "main_benchmark": ["--quick", "--repeats", "1", "--logs", logs],
    }


CLIS = {
    "benchmark": (benchmark, j_benchmark),
    "profile_pipeline": (profile_pipeline, j_profile),
    "benchmark_by_type": (benchmark_by_type, j_by_type),
    "comprehensive_benchmark": (comprehensive_benchmark, j_comprehensive),
    "large_scale_benchmark": (large_scale_benchmark, j_large),
    "main_benchmark": (main_benchmark, j_main),
}
# the CLIs that put tensors on a device; main_benchmark is host only, as in JAX
DEVICE_CLIS = sorted(set(CLIS) - {"main_benchmark"})


@contextlib.contextmanager
def _recording_port():
    """Every instance the port's generators make (float64) and every
    (input, result) of the port pipeline's ``solve`` and of the batched
    device solver that ``profile_pipeline`` times."""
    made, solves = [], []
    fams = tgenerators.FAMILIES
    real = dict(fams)
    real_uniform = tgenerators.generate_uniform_costs
    real_solve = tpipeline.WarmStartPipeline.solve
    real_batch = profiling.lapjv_seeded_batch

    def keep(fn):
        def run(*a, **k):
            C = fn(*a, **k)
            made.append(C)
            return C
        return run

    def solve(self, cost, *a, **k):
        out = real_solve(self, cost, *a, **k)
        c32 = np.asarray(tpipeline._host_array(cost), np.float32)
        solves.append((c32 if c32.ndim == 3 else c32[None], out))
        return out

    def batch(C, *a, **k):
        res = real_batch(C, *a, **k)
        solves.append((C.cpu().numpy(), {"col_of_row": res.col_of_row.cpu().numpy()}))
        return res

    for name, fn in real.items():
        fams[name] = keep(fn)
    tgenerators.generate_uniform_costs = keep(real_uniform)
    tpipeline.WarmStartPipeline.solve = solve
    profiling.lapjv_seeded_batch = batch
    try:
        yield made, solves
    finally:
        fams.update(real)
        tgenerators.generate_uniform_costs = real_uniform
        tpipeline.WarmStartPipeline.solve = real_solve
        profiling.lapjv_seeded_batch = real_batch


def _experiment(logs):
    files = list((Path(logs) / "experiments").glob("*.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())


@pytest.fixture(scope="module", params=sorted(CLIS))
def cli_run(request, ckpt, tmp_path_factory):
    name = request.param
    port, ref = CLIS[name]
    root = tmp_path_factory.mktemp(name)
    runs = {}
    for side, mod in (("jax", ref), ("torch", port)):
        logs = str(root / side)
        argv = [a.replace("{ckpt}", str(ckpt)) for a in _args(logs)[name]]
        if side == "torch" and name in DEVICE_CLIS:
            argv += ["--device", "cpu"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out), _recording_port() as (made, solves):
            ret = mod.main(argv)
        runs[side] = {"stdout": out.getvalue(), "return": ret, "logs": Path(logs),
                      "made": made, "solves": solves}
    return name, runs


def _last_json(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


def _close32(a, b, n, scale):
    return abs(a - b) <= 64 * EPS32 * n * max(scale, 1.0)


def test_cli_summary_and_costs_match_jax(cli_run):
    name, runs = cli_run
    j, t = runs["jax"], runs["torch"]
    j_last, t_last = _last_json(j["stdout"]), _last_json(t["stdout"])
    assert t["return"] == t_last  # the port's main returns what it prints last
    assert list(t_last) == list(j_last)
    if name in ("benchmark", "large_scale_benchmark"):
        g_rows, w_rows = _experiment(t["logs"])["rows"], _experiment(j["logs"])["rows"]
        assert [(r["solver"], r["family"], r["n"]) for r in g_rows] == \
            [(r["solver"], r["family"], r["n"]) for r in w_rows]
        for g, w in zip(g_rows, w_rows):
            if g["solver"] == "warm_pipeline":  # the device's float32 cost
                assert _close32(g["cost"], w["cost"], g["n"], abs(w["cost"]))
            else:
                assert g["cost"] == w["cost"]
        assert t_last.get("measured_instances", 0) == j_last.get("measured_instances", 0)
    elif name == "profile_pipeline":
        for fam in j_last:
            assert list(t_last[fam]) == list(j_last[fam])
    elif name == "benchmark_by_type":
        assert list(t_last["per_family"]) == list(j_last["per_family"])
        for fam, row in j_last["per_family"].items():
            assert list(t_last["per_family"][fam]) == list(row)
            assert t_last["per_family"][fam]["fallback_rate"] == row["fallback_rate"]
            for k in ("u_mae_mean", "u_mae_gauge_mean"):
                assert t_last["per_family"][fam][k] == pytest.approx(row[k], rel=1e-4, abs=1e-5)
    elif name == "comprehensive_benchmark":
        readers = [list(csv.DictReader((r["logs"] / "results.csv").open())) for r in (t, j)]
        assert [list(r[0]) for r in readers] == [list(readers[1][0])] * 2
        for g, w in zip(*readers):
            assert (g["family"], g["n"], g["instance"]) == (w["family"], w["n"], w["instance"])
            assert abs(float(g["primal_gap_pct"]) - float(w["primal_gap_pct"])) <= 1e-4
    else:  # main_benchmark: the host solvers' timing rows, gated first
        g_lines = [json.loads(x) for x in t["stdout"].splitlines() if x.startswith("{")]
        w_lines = [json.loads(x) for x in j["stdout"].splitlines() if x.startswith("{")]
        assert [(r.get("group"), r.get("n")) for r in g_lines] == \
            [(r.get("group"), r.get("n")) for r in w_lines]
        assert all(list(g) == list(w) for g, w in zip(g_lines, w_lines))


def test_cli_assignments_are_optimal(cli_run):
    """Every assignment the port's pipeline (or, in ``profile_pipeline``,
    its ``_solve``) returned, held in float64 to SciPy's optimum of the
    instance it was made from."""
    name, runs = cli_run
    t = runs["torch"]
    if name == "main_benchmark":
        assert not t["solves"]
        return
    assert t["solves"], f"{name} never called the pipeline's solve"
    for c32, out in t["solves"]:
        for b in range(c32.shape[0]):
            src = [C for C in t["made"] if np.array_equal(C.astype(np.float32), c32[b])]
            assert src, "the solved instance is none of the generated ones"
            C = src[0]
            r, c = scipy.optimize.linear_sum_assignment(C)
            opt = float(C[r, c].sum())
            x = out["col_of_row"][b]
            assert sorted(x.tolist()) == list(range(C.shape[0]))
            got = float(C[np.arange(C.shape[0]), x].sum())
            assert abs(got - opt) <= 1e-12 * max(1.0, abs(opt)), (name, got, opt)


def test_cli_parsers_default_to_the_gpu():
    for name in DEVICE_CLIS:
        argv = [a.replace("{ckpt}", "x") for a in _args("logs")[name]]
        assert CLIS[name][0].build_parser().parse_args(argv).device == "cuda", name
    with pytest.raises(SystemExit):  # host only: no --device
        main_benchmark.build_parser().parse_args(["--device", "cpu"])


def test_main_benchmark_gates_with_the_default_host_set(monkeypatch, tmp_path):
    """As in JAX, the gate before each group's timing is
    ``verify_solver_correctness``'s default solver set, on the host."""
    from lapgnn_tpu_torch.solver import verification

    seen = []

    class Stop(Exception):
        pass

    def gate(C, solvers=None, **kw):
        seen.append((C.shape, solvers, sorted(kw)))
        raise Stop

    monkeypatch.setattr(verification, "verify_solver_correctness", gate)
    with pytest.raises(Stop):
        main_benchmark.main(["--quick", "--logs", str(tmp_path)])
    assert seen == [((200, 200), None, ["u", "v"])]


@pytest.mark.parametrize("name", DEVICE_CLIS)
def test_cli_without_a_gpu_raises_unless_given_the_cpu(name, ckpt, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    argv = [a.replace("{ckpt}", str(ckpt)) for a in _args(str(tmp_path / "logs"))[name]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLIS[name][0].main(argv)


def test_regression_device_solve_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        regression.run_regression([8], ["uniform"], repeats=1, include_device=True)
