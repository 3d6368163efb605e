"""Whole runs of each cell on the CPU at tiny sizes: correct as the program
stands, not correct with the timed path broken underneath, the control
failing, a new cell added from files of its own, and the run's guards."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

SEED = 2**31 + 977
CELLS = {
    "solve": "one_gnn_default.solve-2048-closed",
    "train": "dual_gnn_r5.train-4x512",
}


def _run(root, workload, variant=None, trace=False, seed=SEED):
    from lapbench import run

    lines = []
    res = run.run_once(workload, seed, 0.5, trace, root=root, variant=variant, device="cpu",
                       log=lines.append)
    json.dumps(res)  # the line must serialise
    return res, lines


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_is_correct_as_the_program_stands(checkout, cell):
    res, _ = _run(checkout, CELLS[cell])
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell,variant", [
    ("solve", "altered"), ("solve", "control"),
    ("train", "half_batch"), ("train", "unchanged"),
])
def test_broken_timed_path_is_not_correct(checkout, cell, variant):
    res, _ = _run(checkout, CELLS[cell], variant=variant)
    assert not res["correct"], res["checks"]


def test_training_control_fails_on_the_card(checkout, cuda_device):
    """TF32 exists only on the card; there the reference computed in TF32
    in the program's place must fail one of the cell's numbers."""
    from lapbench import run

    res = run.run_once(CELLS["train"], SEED, 0.5, False, root=checkout, variant="control")
    assert not res["correct"], res["checks"]


def test_traced_run_reports_its_per_layer_metrics(checkout):
    res, lines = _run(checkout, CELLS["solve"], trace=True)
    assert {"predict_ms.solve", "device_solve_ms.solve", "step_mfu.solve"} <= set(res["metrics"])
    assert "setup_s" not in res["metrics"]
    assert any(line.startswith("spans") for line in lines)


def test_a_new_cell_needs_only_new_files(checkout):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and new manifest entries; no existing file is edited."""
    before = {p: p.read_bytes() for p in (checkout / "lapbench").rglob("*") if p.is_file()}
    cfg = json.loads((checkout / "lapbench/configs/one_gnn_default.json").read_text())
    cfg["pipeline"]["gate"] = "never"
    (checkout / "lapbench/configs/one_gnn_nogate.json").write_text(json.dumps(cfg))
    mix = json.loads((checkout / "lapbench/traffic/solve-2048-closed.json").read_text())
    mix["families"] = {"uniform": 2}
    (checkout / "lapbench/traffic/solve-uniform-closed.json").write_text(json.dumps(mix))
    (checkout / "lapbench/metrics/requests_per_window.dummy.py").write_text(
        "def read(rec):\n    return float(len(rec['latencies_ms']))\n")
    manifest = json.loads((checkout / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "one_gnn_nogate", "source": "https://example.org/x",
                                "file": "lapbench/configs/one_gnn_nogate.json", "reduced": [],
                                "why": "a test"})
    manifest["workloads"].append({"name": "one_gnn_nogate.solve-uniform-closed",
                                  "config": "one_gnn_nogate", "traffic": "solve-uniform-closed",
                                  "chips": 1, "why": "a test"})
    manifest["end_to_end"][0].setdefault("workloads", []).append("one_gnn_nogate.solve-uniform-closed")
    manifest["per_layer"].append({"name": "requests_per_window.dummy", "unit": "requests",
                                  "better": "higher", "source": "host_clock", "layer": "test",
                                  "moves": manifest["end_to_end"][0]["name"],
                                  "workloads": ["one_gnn_nogate.solve-uniform-closed"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(manifest))
    res, _ = _run(checkout, "one_gnn_nogate.solve-uniform-closed", trace=True)
    assert res["correct"]
    assert res["metrics"]["requests_per_window.dummy"]["value"] >= 1
    for path, data in before.items():
        assert path.read_bytes() == data, path


def _script(root, *extra, env=None):
    return subprocess.run(
        [sys.executable, str(root / "lapbench" / "run.py"), "--workload", CELLS["solve"],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0", *extra],
        cwd=root, capture_output=True, text=True, timeout=300, env=env)


def test_run_without_a_card_prints_no_result(checkout):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = _script(checkout)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_run_beside_only_its_own_files_fails(tmp_path):
    bare = tmp_path / "bare"
    bare.mkdir()
    import shutil

    shutil.copytree(ROOT / "lapbench", bare / "lapbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare)
    res = _script(bare)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_a_loaded_jax_module_fails_the_run(checkout, monkeypatch):
    """The guard reads sys.modules after the window: a module named as the
    JAX package makes the run print no result."""
    from lapbench import run

    monkeypatch.setattr(run, "run_once", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "lapgnn_tpu", type(sys)("lapgnn_tpu"))
    assert run.main(["--workload", CELLS["solve"], "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    monkeypatch.delitem(sys.modules, "lapgnn_tpu")
    assert run.main(["--workload", CELLS["solve"], "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 0


def test_writes_stay_inside_the_checkout(checkout):
    """A run writes no file outside its checkout and its build directory."""
    import glob
    import tempfile

    before = set(glob.glob(os.path.join(tempfile.gettempdir(), "*")))
    _run(checkout, CELLS["solve"])
    after = set(glob.glob(os.path.join(tempfile.gettempdir(), "*")))
    assert after - before == set()
