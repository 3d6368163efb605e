"""The DualGNN-served cell on the CPU at a tiny size: it finds its files,
is correct as the program stands and reports its per-layer metrics; an
altered answer fails ``opt_gap``, a perturbed u and the TF32 control fail
``u_gap``; the forward's least work reads as counted."""

import json

import pytest

from conftest import make_checkout
from lapbench import dual_serve_bound

CELL = "dual_gnn_r5_serve.solve-2048-closed-duals"
# at n = 40 the rounding rule holds the noisy_linear instances alone (the
# reference moved by rounding moves uniform and tie by about 5e-4): this
# seed's order starts with two of them, so that a short window keeps one
SEED = 2**31 + 2012
TINY_N = 40
METRICS = {"step_mfu.dual_solve", "model_roofline_pct.dual_solve", "model_ms.dual_solve",
           "edge_mlp_ms.dual_solve", "attention_ms.dual_solve", "features_ms.dual_solve",
           "device_solve_ms.dual_solve", "host_syncs_per_call.dual_solve",
           "device_idle_pct.dual_solve"}


@pytest.fixture
def checkout(tmp_path):
    root = make_checkout(tmp_path / "checkout")
    path = root / "lapbench" / "traffic" / "solve-2048-closed-duals.json"
    mix = json.loads(path.read_text())
    mix["n"] = TINY_N
    path.write_text(json.dumps(mix))
    return root


def _run(root, variant=None, trace=False, device="cpu"):
    from lapbench import run

    lines = []
    res = run.run_once(CELL, SEED, 0.5, trace, root=root, variant=variant, device=device,
                       log=lines.append)
    json.dumps(res)
    return res, lines


def _readings(lines):
    return json.loads(next(line for line in lines if line.startswith("readings {\"u_gap\"")
                           )[len("readings "):])


def test_cell_is_correct_and_holds_the_model_to_the_reference(checkout):
    from lapbench import manifest, serving

    cell = manifest.Cell(checkout, CELL)
    pool, order = serving.make_pool(type("Ctx", (), {"traffic": cell.traffic, "seed": SEED}))
    assert [pool[i][0] for i in order[:2]] == ["noisy_linear"] * 2
    res, lines = _run(checkout)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["checks"]) == {"opt_gap", "cost_err", "u_gap", "dual_forward_misses"}
    assert {"setup_s", "latency_ms_p50", "latency_ms_p95", "instances_per_s"} == set(res["metrics"])
    got = _readings(lines)
    assert got["kept"] >= 1 and got["dual_forward_misses"] == 0
    assert sum(got["held_by_family"].values()) >= 1  # u_gap compares something
    assert got["held_by_family"].get("sparse", 0) == 0  # its features saturate the attention


def test_traced_run_reports_every_per_layer_metric(checkout):
    """The eight read from the program's spans and counter and the window
    (the tracer recording as ``torch.profiler`` would make it); the device
    trace exists only on the card, so the ninth is read from a trace's
    summary."""
    from lapbench import manifest
    from lapgnn_tpu_torch import tracing

    tracing.take()
    with tracing.record():
        res, _ = _run(checkout, trace=True)
    tracing.take()
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == METRICS - {"device_idle_pct.dual_solve"}
    assert res["metrics"]["host_syncs_per_call.dual_solve"]["value"] >= 2
    assert 0 < res["metrics"]["model_roofline_pct.dual_solve"]["value"]
    readers = dict((m["name"], r) for m, r in manifest.Cell(checkout, CELL).readers(True))
    assert set(readers) == METRICS
    assert readers["device_idle_pct.dual_solve"].read(
        {"trace": {"window_s": 2.0, "busy_s": 0.5}}) == pytest.approx(75.0)


@pytest.mark.parametrize("variant,fails", [("altered", "opt_gap"), ("perturbed", "u_gap")])
def test_a_planted_fault_fails_its_check(checkout, variant, fails):
    res, _ = _run(checkout, variant=variant)
    assert not res["correct"]
    bad = {k for k, c in res["checks"].items() if not c["value"] <= c["limit"]}
    assert fails in bad, res["checks"]


def test_tf32_control_fails_u_gap_on_the_card(tmp_path, cuda_device):
    """TF32 exists only on the card; there the program's products in TF32
    must fail ``u_gap`` and nothing else."""
    root = make_checkout(tmp_path / "full", tiny=False)
    res, _ = _run(root, variant="control", device=None)
    bad = {k for k, c in res["checks"].items() if not c["value"] <= c["limit"]}
    assert bad == {"u_gap"}, res["checks"]


def test_least_work_of_the_forward():
    """At n = 2048 and r5's widths: about 0.98 TFLOP (edge_fc3 folded), so
    about 14.6 ms at 67 TFLOP/s, bound by the FLOPs; the folded count is
    below the training cell's unfolded one."""
    from lapbench import yardstick

    flops = dual_serve_bound.forward_flops(2048, 256, 6, 4)
    assert flops == 6 * (2048**2 * 38400 + 16 * 2048 * 256**2) + 4 * 2048 * 14 * 256 + 4 * 2048 * 256
    assert 0.97e12 < flops < 0.99e12
    least = dual_serve_bound.forward_least_s(2048, 256, 6, 4)
    assert least == pytest.approx(flops / yardstick.F32_OPS_PER_S)
    assert flops < yardstick.dual_forward_flops(2048, 256, 6)
    rec = {"config": {"hidden": 256, "layers": 6, "heads": 4}, "n": 2048,
           "instances": 10, "window_s": 1.0}
    assert dual_serve_bound.solve_mfu_pct(rec) == pytest.approx(
        100 * 10 * dual_serve_bound.instance_least_s(2048, 256, 6, 4))
    assert dual_serve_bound.model_roofline_pct(rec, 1e3 * least) == pytest.approx(100.0)
    assert dual_serve_bound.model_roofline_pct(rec, None) is None
