"""The per-layer metrics that read the program's own spans and counters
(``lapgnn_tpu_torch.tracing``): reported by a traced run whose window
the tracer records, absent where it records nothing or the program has no
tracer."""

import math
import sys

import pytest

from conftest import ROOT  # noqa: F401  (puts the repository on the path)

SEED = 2**31 + 977
CELLS = {
    "solve": "one_gnn_default.solve-2048-closed",
    "train": "dual_gnn_r5.train-4x512",
}
NEW = {
    "solve": ["upload_ms.solve", "features_ms.solve", "model_ms.solve", "seed_ms.solve",
              "host_syncs_per_call.solve"],
    "train": ["features_ms.train", "loss_ms.train", "backward_ms.train",
              "host_syncs_per_step.train"],
}


def _run(root, workload):
    from lapbench import run

    return run.run_once(workload, SEED, 0.5, True, root=root, device="cpu", log=lambda _: None)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_run_inside_record_reports_the_program_metrics(checkout, cell, capfd):
    from lapgnn_tpu_torch import tracing

    tracing.take()
    try:
        with tracing.record():
            res = _run(checkout, CELLS[cell])
    finally:
        tracing.take()
    for name in NEW[cell]:
        value = res["metrics"][name]["value"]
        assert isinstance(value, float) and math.isfinite(value) and value >= 0, (name, value)
    syncs = NEW[cell][-1]
    assert res["metrics"][syncs]["value"] > 0  # the solve's readback; the step's feature copies
    assert "program spans" in capfd.readouterr().err


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_program_metrics_are_absent_where_the_tracer_did_not_record(checkout, cell):
    from lapgnn_tpu_torch import tracing

    tracing.take()
    res = _run(checkout, CELLS[cell])
    assert res["correct"], res["checks"]
    assert not set(NEW[cell]) & set(res["metrics"])


def test_readers_give_none_for_a_program_without_the_tracer(monkeypatch):
    """An older program has no ``tracing``: the readers give None and
    raise nothing."""
    import lapgnn_tpu_torch
    from lapbench import program_spans
    from lapgnn_tpu_torch import tracing

    tracing.take()
    with tracing.record(), tracing.span("solve"):
        tracing.count("host_syncs")
    assert program_spans.mean_count("lapgnn.solve", "host_syncs") == 1
    monkeypatch.delattr(lapgnn_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "lapgnn_tpu_torch.tracing", None)
    assert program_spans.mean_ms("lapgnn.solve") is None
    assert program_spans.mean_count("lapgnn.solve", "host_syncs") is None
    monkeypatch.undo()
    tracing.take()
