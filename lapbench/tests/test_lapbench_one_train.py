"""OneGNN's progressive training cell on the CPU at a small size: it finds its
files, is correct as the program stands and reports its per-layer metrics;
a half batch, a skipped update and a greedy bound that visits the rows in
the wrong order each fail their check, and the TF32 control fails on the
card; the step's least work reads as counted."""

import json

import pytest
import torch

from conftest import make_checkout
from lapbench import one_train_bound, yardstick

CELL = "one_gnn_progressive.train-16x2048"
SEED = 2**31 + 977
TINY = {"n": 24, "batch": 4, "pool": 8}
CHECKS = {"forward_gap", "grad_gap", "change_gap", "loss_gap"}
# the cell's own readers, and the DualGNN training cell's that read the same
# spans, counter and trace
METRICS = {"normalize_ms.one_train", "forward_ms.one_train", "refine_ms.one_train",
           "step_mfu.one_train", "host_syncs_per_call.one_train", "features_ms.train",
           "loss_ms.train", "backward_ms.train", "host_syncs_per_step.train",
           "device_idle_pct.train"}


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    """The cell cut to n = 24, with the program's cache and readback gates
    lowered to it, so that the small run takes the path n = 2048 takes."""
    from lapgnn_tpu_torch.train import progressive

    root = make_checkout(tmp_path / "checkout")
    path = root / "lapbench" / "traffic" / "train-16x2048.json"
    mix = json.loads(path.read_text())
    mix.update(TINY)
    path.write_text(json.dumps(mix))
    monkeypatch.setattr(progressive, "DEVICE_CACHE_MIN_N", TINY["n"])
    monkeypatch.setattr(progressive, "SYNC_MIN_N", TINY["n"])
    return root


def _run(root, variant=None, trace=False, device="cpu"):
    from lapbench import run

    lines = []
    res = run.run_once(CELL, SEED, 0.5, trace, root=root, variant=variant, device=device,
                       log=lines.append)
    json.dumps(res)
    return res, lines


def _readings(lines):
    line = next(line for line in lines if line.startswith("readings "))
    return json.loads(line[len("readings "):])


def test_cell_is_correct_and_holds_the_step_to_the_reference(checkout):
    res, lines = _run(checkout)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 3
    assert set(res["checks"]) == CHECKS
    assert set(res["metrics"]) == {"setup_s", "train_samples_per_s"}
    got = _readings(lines)
    assert got["held"] == TINY["batch"]  # every instance's forward is compared
    assert got["grad_gap"] == got["grad_gap_median_leaf"] > 0  # the gradient is compared
    assert any("cached on the device: [(8, 24, 24)]" in line for line in lines)


def test_traced_run_reports_every_per_layer_metric(checkout):
    """The nine read from the program's spans and counter and the window
    (the tracer recording as ``torch.profiler`` would make it); the device
    trace exists only on the card, so the tenth is read from a trace's
    summary."""
    from lapbench import manifest
    from lapgnn_tpu_torch import tracing

    tracing.take()
    with tracing.record():
        res, _ = _run(checkout, trace=True)
    tracing.take()
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == METRICS - {"device_idle_pct.train"}
    assert res["metrics"]["host_syncs_per_step.train"]["value"] == 1  # the positional code
    # and the call's: the index upload, the positional code, the readback
    assert res["metrics"]["host_syncs_per_call.one_train"]["value"] == 3
    metric = {k: v["value"] for k, v in res["metrics"].items()}
    assert metric["refine_ms.one_train"] <= metric["forward_ms.one_train"]
    assert 0 < res["metrics"]["step_mfu.one_train"]["value"] < 100
    readers = dict((m["name"], r) for m, r in manifest.Cell(checkout, CELL).readers(True))
    assert set(readers) == METRICS
    assert readers["device_idle_pct.train"].read(
        {"trace": {"window_s": 2.0, "busy_s": 0.5}}) == pytest.approx(75.0)


@pytest.mark.parametrize("variant,fails", [("half_batch", {"forward_gap", "grad_gap", "loss_gap"}),
                                           ("unchanged", {"grad_gap", "change_gap"}),
                                           ("greedy_order", {"loss_gap"})])
def test_a_planted_fault_fails_its_checks(checkout, variant, fails):
    res, _ = _run(checkout, variant=variant)
    assert not res["correct"]
    bad = {k for k, c in res["checks"].items() if not float(c["value"]) <= c["limit"]}
    assert fails <= bad, res["checks"]


def test_tf32_control_fails_on_the_card(tmp_path, cuda_device):
    """TF32 exists only on the card; there the reference computed in TF32
    in the program's place must fail one of the cell's numbers, and not
    every one."""
    root = make_checkout(tmp_path / "full", tiny=False)
    res, _ = _run(root, variant="control", device=None)
    bad = {k for k, c in res["checks"].items() if not float(c["value"]) <= c["limit"]}
    assert bad and bad != CHECKS, res["checks"]


def test_least_work_of_the_step():
    """Three forwards' model FLOPs: PyTorch's counter over a forward and
    backward counts them less the input projection's gradient of its input
    (the features need none).  At n = 2048, batch 16 and the artifact's
    widths: about 179 GFLOP, 2.67 ms at 67 TFLOP/s, bound by the FLOPs
    (one read of the batch's costs: 0.080 ms)."""
    from torch.utils.flop_counter import FlopCounterMode

    from lapgnn_tpu_torch.models import OneGNN
    from lapgnn_tpu_torch.ops.features import row_features

    n, hidden, layers, topk, B = 12, 16, 3, 4, 2
    model = OneGNN(hidden=hidden, layers=layers, topk=topk, dropout=0.0)
    cost = torch.rand(B, n, n)
    with FlopCounterMode(display=False) as counter:
        model(row_features(cost), cost=cost)["u"].square().sum().backward()
    no_input_grad = B * 2 * n * 21 * hidden
    assert counter.get_total_flops() + no_input_grad == one_train_bound.step_flops(
        n, hidden, layers, topk, B)
    flops = one_train_bound.step_flops(2048, 192, 4, 16, 16)
    assert flops == 3 * 16 * yardstick.one_gnn_forward_flops(2048, 192, 4, 16)
    assert 1.78e11 < flops < 1.80e11
    least = one_train_bound.step_least_s(2048, 192, 4, 16, 16)
    assert least == pytest.approx(flops / yardstick.F32_OPS_PER_S)
    assert one_train_bound.step_bytes(2048, 16) / yardstick.HBM_BYTES_PER_S < least / 30
    rec = {"config": {"hidden": 192, "layers": 4, "topk": 16}, "n": 2048, "batch": 16,
           "steps": 100, "window_s": 30.0}
    assert one_train_bound.step_mfu_pct(rec) == pytest.approx(100 * 100 * least / 30.0)
    assert one_train_bound.step_mfu_pct({**rec, "steps": 0}) is None
