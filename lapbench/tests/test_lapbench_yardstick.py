"""The benchmark's arithmetic: window statistics over every request, FLOP
counts against PyTorch's counter, the kernels' classes, the no-JAX check."""

import importlib.util
import statistics

import pytest
import torch

from conftest import ROOT
from lapbench import yardstick


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "lapbench" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _window(latencies):
    return {"latencies_ms": latencies, "instances_ok": len(latencies),
            "window_s": sum(latencies) / 1e3, "setup_s": 1.0}


def test_a_planted_stall_moves_the_tail_and_the_rate():
    steady = [20.0 + 0.01 * i for i in range(300)]
    stalled = list(steady)
    for i in range(0, 300, 10):  # one request in ten stalls 100 ms
        stalled[i] += 100.0
    p95, rate, p50 = _reader("latency_ms_p95"), _reader("instances_per_s"), _reader("latency_ms_p50")
    assert p95(_window(stalled)) > p95(_window(steady)) + 50.0
    assert rate(_window(stalled)) < 0.8 * rate(_window(steady))
    assert abs(p50(_window(stalled)) - p50(_window(steady))) < 1.0


def test_a_failed_request_counts_against_the_tail():
    lat = [10.0] * 99 + [float("inf")]
    assert yardstick.percentile(lat, 50) == 10.0
    assert yardstick.percentile(lat, 100) == float("inf")
    assert yardstick.percentile([float("inf")] * 10 + [1.0] * 90, 95) == float("inf")


@pytest.mark.parametrize("q", [0, 25, 50, 95, 100])
def test_percentile_is_numpys_linear(q):
    import numpy as np

    xs = [float(x) for x in np.random.default_rng(q).exponential(size=37)]
    assert yardstick.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert yardstick.spread(xs) == pytest.approx((q3 - q1) / q2)


@pytest.mark.parametrize("n,hidden,layers,heads", [(6, 16, 2, 4), (9, 8, 1, 2)])
def test_dual_forward_flops_match_the_flop_counter(n, hidden, layers, heads):
    """The counter counts the edge terms as the dense block-diagonal product
    the model takes them in; the yardstick counts the dots they need."""
    from torch.utils.flop_counter import FlopCounterMode

    from lapgnn_tpu_torch.models import DualGNN
    from lapgnn_tpu_torch.ops.features import graph_features

    model = DualGNN(hidden_dim=hidden, layers=layers, heads=heads, dropout=0.0)
    cost = torch.rand(1, n, n)
    gf = graph_features(cost)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(gf.edge_feat, gf.row_feat, gf.col_feat)
    block_diagonal = layers * 2 * n * n * hidden * 2 * heads
    needed = layers * 4 * n * n * hidden
    assert counter.get_total_flops() - block_diagonal + needed == yardstick.dual_forward_flops(
        n, hidden, layers)


def test_dual_train_flops_match_the_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    from lapgnn_tpu_torch.models import DualGNN
    from lapgnn_tpu_torch.ops.features import graph_features

    n, hidden, layers, heads = 6, 16, 2, 4
    model = DualGNN(hidden_dim=hidden, layers=layers, heads=heads, dropout=0.0)
    gf = graph_features(torch.rand(1, n, n))
    with FlopCounterMode(display=False) as counter:
        out = model(gf.edge_feat, gf.row_feat, gf.col_feat)
        (out["u"].sum() + out["v_hint"].sum()).backward()
    # the block-diagonal edge product: forward, and both of its gradients
    waste = 3 * layers * (2 * n * n * hidden * 2 * heads - 4 * n * n * hidden)
    assert counter.get_total_flops() - waste == yardstick.dual_train_flops(n, hidden, layers)


def test_one_gnn_forward_flops_match_the_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    from lapgnn_tpu_torch.models import OneGNN
    from lapgnn_tpu_torch.ops.features import row_features

    n, hidden, layers, topk = 12, 16, 3, 4
    model = OneGNN(hidden=hidden, layers=layers, topk=topk, dropout=0.0).eval()
    cost = torch.rand(1, n, n)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(row_features(cost), cost=cost)
    assert counter.get_total_flops() == yardstick.one_gnn_forward_flops(n, hidden, layers, topk)


def test_no_jax_check_compares_whole_top_level_names():
    assert yardstick.banned_modules(["lapgnn_tpu_torch", "lapgnn_tpu_torch.pipeline", "jaxtyping",
                                     "flaxen", "numpy"]) == []
    for name in ("lapgnn_tpu", "lapgnn_tpu.pipeline", "jax", "jax.numpy", "jaxlib", "flax.linen"):
        assert yardstick.banned_modules([name, "numpy"]) == [name]


@pytest.mark.parametrize("trace_name,cls", [
    ("void augment_kernel<false>(float const*, ...)", "solver"),
    ("arr_kernel", "solver"),
    ("greedy_match_kernel(unsigned int const*)", "solver"),
    ("greedy_kernel(float const*, float const*)", "greedy_total"),
    ("void row_features_smem_kernel<4>(...)", "row_features"),
    ("colmin_cluster", "col_min"),
    ("colmin_finish", "none"),
    ("twomin_kernel", "two_min"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", None),
    ("ampere_sgemm_128x64_nn", None),
])
def test_kernel_classes(trace_name, cls):
    assert yardstick.kernel_class(trace_name) == cls


def test_roofline_share_is_bound_over_time():
    rec = {"n": 2048, "batch": 1, "trace": {"kernels": {
        "augment_kernel": [10, 1e-3], "row_features_reg_kernel<8>": [10, 1e-3], "gemm": [5, 1.0]}}}
    bound = 10 * yardstick.kernel_bound_s("solver", 1, 2048, 2048) + 10 * yardstick.kernel_bound_s(
        "row_features", 1, 2048, 2048)
    assert yardstick.kernel_roofline_pct(rec) == pytest.approx(100 * bound / 2e-3)
    assert yardstick.kernel_roofline_pct({"n": 2, "batch": 1, "trace": {"kernels": {}}}) is None
