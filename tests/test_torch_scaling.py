"""The port's scaling CLI (``lapgnn_tpu_torch.cli.scaling_benchmark``) on the CPU.

``main`` runs with two mesh sizes (1 and 2 gloo ranks, spawned by the CLI)
and writes the JSON keys of the JAX package's CLI, each value finite where
JAX's is (no value of JAX's is null at these arguments on the CPU).  JAX's
CLI takes minutes here (its fold-differencing calibrates to 1.5 s folds), so
its keys are written out below, as it prints them at these arguments with
``JAX_PLATFORMS=cpu``; its CPU run times no fused feature kernel, so the
``row_features_pallas_*`` keys are absent on the CPU in both.
"""

import json
import math

from lapgnn_tpu_torch.cli import scaling_benchmark

ARGV = ["--meshes", "1", "2", "--n", "64", "--batch", "2", "--repeats", "1",
        "--roofline-n", "64", "--device", "cpu"]
TOP_KEYS = ["backend", "device", "hbm_peak_gbs", "pipeline_edges_per_s_per_mesh", "roofline"]
MESH_KEYS = ["edges_per_s", "scaling_efficiency", "time_ms"]
ROOFLINE_KEYS = [
    "stream_reduce_selfcheck_gb_s", "min_trick_xla_gb_s", "min_trick_xla_roofline_pct",
    "min_trick_pallas_gb_s", "min_trick_pallas_roofline_pct", "min_trick_routed_gb_s",
    "min_trick_routed_roofline_pct", "min_trick_route_ok", "row_features_gb_s",
    "row_features_edges_per_s",
]


def test_scaling_cli_writes_jax_keys(tmp_path, capsys):
    out = tmp_path / "scaling.json"
    ret = scaling_benchmark.main(ARGV + ["--output", str(out)])
    written = json.loads(out.read_text())
    assert list(written) == TOP_KEYS
    assert written == json.loads(json.dumps(ret))
    assert written["backend"] == "cpu" and written["hbm_peak_gbs"] == 3350.0
    meshes = written["pipeline_edges_per_s_per_mesh"]
    assert list(meshes) == ["1", "2"]
    for row in meshes.values():
        assert list(row) == MESH_KEYS
        assert all(math.isfinite(row[k]) and row[k] > 0 for k in MESH_KEYS)
    assert meshes["1"]["scaling_efficiency"] == 1.0
    assert list(written["roofline"]) == ["64"]
    entry = written["roofline"]["64"]
    assert list(entry) == ROOFLINE_KEYS
    for k in ROOFLINE_KEYS:
        if k == "min_trick_route_ok":
            assert isinstance(entry[k], bool)
        else:
            assert math.isfinite(entry[k]) and entry[k] >= 0, k
    printed = capsys.readouterr().out
    assert "mesh model=1:" in printed and "mesh model=2:" in printed


def test_scaling_cli_skips_meshes_it_cannot_place(tmp_path, capsys):
    """A mesh that does not divide n, or has more ranks than cores, is
    skipped with JAX's line; the roofline block still runs, with --solve."""
    ret = scaling_benchmark.main(["--meshes", "3", "100000", "--n", "64", "--repeats", "1",
                                  "--roofline-n", "32", "--solve", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "# skip mesh model=3 (devices=" in printed and "n%m=1)" in printed
    assert "# skip mesh model=100000" in printed
    assert ret["pipeline_edges_per_s_per_mesh"] == {}
    entry = ret["roofline"][32]
    assert math.isfinite(entry["warm_solve_ms"]) and entry["warm_solve_edges_per_s"] > 0
