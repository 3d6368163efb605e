"""The port's tracer (``lapgnn_tpu_torch.tracing``) on the CPU: off, it
records nothing and opens no profiler range; on, under ``torch.profiler`` or
``tracing.record()``, a solve call, a DualGNN train step and a certified
stream each give their span tree, with parents and one request id a unit of
work, on the profiler's clock; the ``host_syncs`` counter adds up the
solver's syncs and the call's own; ``SolveStats(timed=True)`` times its
stages through the tracer's spans; on the card, each span's ``host_syncs``
equals the syncs that ``torch.cuda.set_sync_debug_mode("warn")`` reports."""

import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from lapgnn_tpu_torch.data.generators import FAMILIES
from lapgnn_tpu_torch.pipeline import WarmStartPipeline
from lapgnn_tpu_torch.solver.jv import SolveStats
from lapgnn_tpu_torch.solver.seeded import lapjv_seeded_single
from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint
from lapgnn_tpu_torch.train.dual_trainer import build_dual_gnn, make_dual_train_step
from lapgnn_tpu_torch.train import progressive
from lapgnn_tpu_torch.train.schedule import make_optimizer
from lapgnn_tpu_torch.train.trainer import build_one_gnn, make_train_step, trainable_parameters
from lapgnn_tpu_torch import tracing
from lapgnn_tpu_torch.utils.profiling import trace

CKPT = Path(__file__).resolve().parent.parent / "artifacts" / "one_gnn_default"
STAGES = ("project_tighten", "greedy", "arr", "augment", "polish")

# span -> its parent's span, per request
SEEDED = {"lapgnn.seeded": "lapgnn.e2e",
          **{f"lapgnn.seeded.{stage}": "lapgnn.seeded" for stage in STAGES}}
E2E = {"lapgnn.decode": "lapgnn.e2e", "lapgnn.predict": "lapgnn.e2e",
       "lapgnn.predict.features": "lapgnn.predict", "lapgnn.predict.model": "lapgnn.predict",
       "lapgnn.one.refine": "lapgnn.predict.model", "lapgnn.predict.seed": "lapgnn.predict",
       **SEEDED}
TREES = {
    "solve": {"lapgnn.solve": None, "lapgnn.stage": "lapgnn.solve",
              "lapgnn.e2e": "lapgnn.solve", "lapgnn.readback": "lapgnn.solve", **E2E},
    "solve_certified": {"lapgnn.solve": None, "lapgnn.stage": "lapgnn.solve",
                        "lapgnn.e2e": "lapgnn.solve", "lapgnn.readback": "lapgnn.solve",
                        "lapgnn.certify": "lapgnn.solve", **E2E},
    "train": {"lapgnn.train.step": None,
              **{f"lapgnn.train.{s}": "lapgnn.train.step"
                 for s in ("features", "forward", "loss", "backward", "optimizer")},
              "lapgnn.dual.edge": "lapgnn.train.forward",
              "lapgnn.dual.attention": "lapgnn.train.forward"},
    "one_train": {"lapgnn.train.step": None,
                  **{f"lapgnn.train.{s}": "lapgnn.train.step" for s in
                     ("normalize", "features", "forward", "loss", "backward", "optimizer")},
                  "lapgnn.one.refine": "lapgnn.train.forward"},
    "stream": {"lapgnn.stream.pack": None, "lapgnn.stream.upload": None,
               "lapgnn.stream.solve": None, "lapgnn.stream.wait_upload": "lapgnn.stream.solve",
               "lapgnn.e2e": "lapgnn.stream.solve", "lapgnn.readback": "lapgnn.stream.solve",
               "lapgnn.stream.certify": None, "lapgnn.certify": "lapgnn.stream.certify",
               "lapgnn.stream.wait_certify": None, **E2E},
}
REQUESTS = {"solve": 1, "solve_certified": 1, "train": 1, "one_train": 1, "stream": 2}
# spans that open more than once a request: the train fixture's model has two layers
REPEATS = {"train": {"lapgnn.dual.edge": 2, "lapgnn.dual.attention": 2}}
# spans that run on the stream's worker threads, which the profiler does not see
WORKERS = {"lapgnn.stream.pack", "lapgnn.stream.upload", "lapgnn.stream.certify",
           "lapgnn.certify"}


def _cost(fam, n, seed):
    return FAMILIES[fam](n, np.random.default_rng(seed)).astype(np.float32)


@pytest.fixture(scope="module")
def pipe():
    params, meta, _ = load_checkpoint(CKPT)
    return WarmStartPipeline(build_model_from_meta(meta), params, device="cpu")


@pytest.fixture(scope="module")
def train():
    torch.manual_seed(0)
    model = build_dual_gnn(16, 2, 2, 0.1, seed=3, device="cpu")
    opt = make_optimizer(list(model.parameters()), 1e-3, 1e-4, 1.0)
    cost = torch.from_numpy(np.stack([_cost(f, 12, 7) for f in ("uniform", "sparse")]))
    u = cost.amin(-1)
    return make_dual_train_step(model, opt), cost, u, torch.Generator().manual_seed(5)


@pytest.fixture(scope="module")
def one_train():
    """OneGNN's train step as ``train_progressive`` makes it: cost
    refinement, normalised costs and gap, dropout on."""
    model = build_one_gnn(16, 2, 0.1, 4, seed=3, device="cpu")
    opt = make_optimizer(trainable_parameters(model, True), 1e-3, 1e-4, 1.0)
    cost = torch.from_numpy(np.stack([_cost(f, 12, 7) for f in ("uniform", "sparse")]))
    step = make_train_step(model, opt, True, normalize_gap=True, normalize_costs=True)
    return step, cost, cost.amin(-1), torch.Generator().manual_seed(5)


@pytest.fixture(scope="module")
def calls(pipe, train, one_train):
    """path -> the call it makes."""
    step, cost, u, gen = train
    one_step, one_cost, one_u, one_gen = one_train
    C, C2 = _cost("uniform", 32, 1), _cost("noisy_linear", 32, 2)
    return {
        "solve": lambda: pipe.solve(C),
        "solve_certified": lambda: pipe.solve(C2, certify=True),
        "train": lambda: step(cost, u, gen),
        "one_train": lambda: one_step(one_cost, one_u, one_gen),
        "stream": lambda: pipe.solve_stream([C, C2], certify=True),
    }


@pytest.fixture(autouse=True)
def empty_tracer():
    tracing.take()
    yield
    tracing.take()


def _profiled(fn):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    return prof


def _record(how, fn):
    if how == "profiler":
        return _profiled(fn)
    with tracing.record():
        fn()
    return None


def _hold_tree(spans, tree, requests, repeats=None):
    by_id = {s.id: s for s in spans}
    by_request = {}
    for s in spans:
        by_request.setdefault(s.request, []).append(s)
    assert len(by_request) == requests, sorted(by_request)
    names = sorted(n for n in tree for _ in range((repeats or {}).get(n, 1)))
    for group in by_request.values():
        assert sorted(s.name for s in group) == names
        for s in group:
            parent = by_id[s.parent].name if s.parent is not None else None
            assert parent == tree[s.name], (s.name, parent)
            assert s.parent is None or by_id[s.parent].request == s.request
            assert s.start_ns <= s.end_ns
            if s.parent is not None:
                outer = by_id[s.parent]
                assert outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns, s.name


@pytest.mark.parametrize("path", ["solve", "train"])
def test_off_records_nothing_and_opens_no_range(calls, path, monkeypatch):
    def no_range(*args, **kwargs):
        raise AssertionError("a profiler range opened with the tracer off")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_range)
    assert not tracing.enabled()
    before = tracing.counters()
    calls[path]()
    assert tracing.take() == []
    after = tracing.counters()  # counters count all the same
    assert [k for k in after if after[k] > before.get(k, 0)]


def test_off_span_is_one_shared_context():
    assert tracing.span("a") is tracing.span("b", torch.device("cpu"), request=3)
    with tracing.span("a") as s:
        assert s is None


@pytest.mark.parametrize("how", ["profiler", "record"])
@pytest.mark.parametrize("path", sorted(TREES))
def test_span_tree(calls, path, how):
    _record(how, calls[path])
    _hold_tree(tracing.take(), TREES[path], REQUESTS[path], REPEATS.get(path))


@pytest.mark.parametrize("path", sorted(TREES))
def test_spans_share_the_profiler_clock(calls, path):
    """Each span's host interval is its ``lapgnn.*`` range's in the
    profiler's events within 1 ms at each end."""
    prof = _profiled(calls[path])
    spans = tracing.take()
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("lapgnn."):
            events.setdefault(ev.name(), []).append(ev)
    seen = set(events)
    expected = set(TREES[path]) - (WORKERS if path == "stream" else set())
    assert seen == expected
    for name in seen:
        mine = sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)
        theirs = sorted(events[name], key=lambda e: e.start_ns())
        assert len(mine) == len(theirs), name
        for s, ev in zip(mine, theirs):
            assert abs(s.start_ns - ev.start_ns()) <= 1_000_000, name
            assert abs(s.end_ns - (ev.start_ns() + ev.duration_ns())) <= 1_000_000, name


@pytest.mark.parametrize("fam", ["uniform", "sparse", "tie"])
def test_host_syncs_add_up_over_a_solve(pipe, fam):
    """The call's ``host_syncs`` delta: the solver's syncs, the upload and
    the readback, and the predict's copies to the device: on the CPU the
    eager Sinkhorn ladder's, one temperature a rung; the row features'
    positional code and the seed's quantiles are made in place."""
    C = _cost(fam, 32, 11)
    with tracing.record():
        pipe.solve(C)
    spans = {s.name: s for s in tracing.take()}
    solver = sum(st.host_syncs for st in pipe.last_solve_stats)
    assert solver > 0  # the CPU solve's loops read their conditions
    assert spans["lapgnn.seeded"].counts("host_syncs") == solver
    assert spans["lapgnn.stage"].counts("host_syncs") == 1
    assert spans["lapgnn.readback"].counts("host_syncs") == 1
    predict = spans["lapgnn.predict"].counts("host_syncs")
    assert spans["lapgnn.predict.features"].counts("host_syncs") == 0
    assert spans["lapgnn.predict.seed"].counts("host_syncs") == 4
    assert predict == sum(spans[f"lapgnn.predict.{p}"].counts("host_syncs")
                          for p in ("features", "model", "seed"))
    assert spans["lapgnn.solve"].counts("host_syncs") == solver + 2 + predict


def test_host_syncs_of_a_train_step(train):
    """The exact divisions and the positional codes copy nothing to the
    device: their constants are made in place."""
    step, cost, u, gen = train
    with tracing.record():
        step(cost, u, gen)
    spans = {s.name: s for s in tracing.take()}
    assert spans["lapgnn.train.step"].counts("host_syncs") == 0
    assert spans["lapgnn.train.features"].counts("host_syncs") == 0


def test_host_syncs_of_a_one_gnn_train_step(one_train):
    """The row features' positional code is made in place: the step copies
    nothing."""
    step, cost, u, gen = one_train
    with tracing.record():
        step(cost, u, gen)
    spans = {s.name: s for s in tracing.take()}
    assert spans["lapgnn.train.step"].counts("host_syncs") == 0
    assert spans["lapgnn.train.features"].counts("host_syncs") == 0


def test_host_syncs_of_a_hybrid_solve():
    params, meta, _ = load_checkpoint(CKPT)
    hybrid = WarmStartPipeline(build_model_from_meta(meta), params, mode="hybrid", device="cpu")
    with tracing.record():
        hybrid.solve(_cost("uniform", 32, 4))
    spans = {s.name: s for s in tracing.take()}
    assert sorted(spans) == ["lapgnn.one.refine", "lapgnn.predict", "lapgnn.predict.features",
                             "lapgnn.predict.model", "lapgnn.predict.seed", "lapgnn.solve",
                             "lapgnn.stage"]
    assert spans["lapgnn.predict"].parent == spans["lapgnn.solve"].id
    predict = spans["lapgnn.predict"].counts("host_syncs")
    # the upload and the one (u, v) copy
    assert spans["lapgnn.solve"].counts("host_syncs") == predict + 2


def test_timed_stages_are_tracer_spans():
    C = torch.from_numpy(_cost("uniform", 24, 5))
    u = C.amin(1)
    v = (C - u[:, None]).amin(0)
    timed = SolveStats(timed=True)
    lapjv_seeded_single(C, u, v, stats=timed)
    assert tracing.take() == []  # timed, not recorded
    assert set(timed.stage_ms) == set(STAGES)
    assert all(ms >= 0 for ms in timed.stage_ms.values())
    again = SolveStats(timed=True)
    with tracing.record():
        lapjv_seeded_single(C, u, v, stats=again)
    names = [s.name for s in tracing.take()]
    assert sorted(names) == sorted(["lapgnn.seeded"] + [f"lapgnn.seeded.{s}" for s in STAGES])
    assert set(again.stage_ms) == set(STAGES)


def test_request_ids_and_nesting_across_calls():
    with tracing.record():
        for _ in range(2):
            with tracing.span("outer") as outer:
                with tracing.span("inner") as inner:
                    pass
            assert inner.parent == outer.id and inner.request == outer.request == outer.id
        rid = tracing.new_request()
        with tracing.span("given", request=rid) as given:
            pass
    spans = tracing.take()
    assert [s.name for s in spans] == ["lapgnn.inner", "lapgnn.outer"] * 2 + ["lapgnn.given"]
    assert spans[1].request != spans[3].request
    assert given.request == rid and given.parent is None
    assert given.device_ms is None and given.ms == given.host_ms


def test_record_nests_and_take_drains():
    with tracing.record():
        with tracing.record():
            pass
        assert tracing.enabled()
        with tracing.span("x"):
            pass
    assert not tracing.enabled()
    assert len(tracing.recorded()) == 1
    assert [s.name for s in tracing.take()] == ["lapgnn.x"]
    assert tracing.take() == [] and tracing.recorded() == []


@pytest.mark.parametrize("inside_record", [False, True])
def test_trace_keeps_no_stale_spans(pipe, tmp_path, inside_record):
    """``utils.profiling.trace()`` drops the spans it recorded (they stay in
    its Chrome trace), so a later ``record()`` reads its own alone; inside
    a ``record()`` block it leaves them to the block."""
    C = _cost("uniform", 32, 1)
    if inside_record:
        with tracing.record(), trace(tmp_path):
            pipe.solve(C)
        assert sorted(s.name for s in tracing.take()) == sorted(TREES["solve"])
    else:
        with trace(tmp_path):
            pipe.solve(C)
        assert tracing.recorded() == []
        with tracing.record(), tracing.span("later"):
            pass
        assert [s.name for s in tracing.take()] == ["lapgnn.later"]
    assert '"lapgnn.solve"' in (tmp_path / "trace.json").read_text()


def test_the_store_keeps_the_newest_spans():
    with tracing.record():
        for _ in range(tracing.MAX_SPANS + 5):
            with tracing.span("x"):
                pass
    spans = tracing.recorded()
    assert len(spans) == tracing.MAX_SPANS
    assert spans[-1].id - spans[0].id == tracing.MAX_SPANS - 1


@pytest.mark.parametrize("copy", ["numbers_to_device", "tensor_to_device", "to_host", "item"])
def test_each_copy_counts_one_sync(copy):
    t = torch.arange(3.0)
    cpu = torch.device("cpu")
    calls = {
        "numbers_to_device": lambda: tracing.to_device([1.0, 2.0], cpu, torch.float64),
        "tensor_to_device": lambda: tracing.to_device(t, cpu),
        "to_host": lambda: tracing.to_host(t),
        "item": lambda: tracing.item(t[1]),
    }
    expect = {
        "numbers_to_device": torch.tensor([1.0, 2.0], dtype=torch.float64),
        "tensor_to_device": t, "to_host": t, "item": 1.0,
    }
    before = tracing.counters()["host_syncs"]
    out = calls[copy]()
    assert tracing.counters()["host_syncs"] == before + 1
    if copy == "item":
        assert out == expect[copy]
    else:
        assert torch.equal(out, expect[copy]) and out.dtype == expect[copy].dtype


def test_threads_lose_no_count_and_no_span():
    """More threads than cores, switching often: every count and every
    closed span lands, each span under its own thread's parent."""
    import os
    import sys
    import threading

    threads, each = 2 * (os.cpu_count() or 4), 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = tracing.counters()["host_syncs"]

        def work():
            for _ in range(each):
                with tracing.span("outer"), tracing.span("inner"):
                    tracing.count("host_syncs")

        with tracing.record():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    spans = tracing.take()
    assert tracing.counters()["host_syncs"] - before == threads * each
    assert len(spans) == 2 * threads * each
    by_id = {s.id: s for s in spans}
    assert all(by_id[s.parent].name == "lapgnn.outer" for s in spans if s.name == "lapgnn.inner")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_span_on_a_cuda_device_records_events(cuda):
    with tracing.record():
        with tracing.span("kernel", cuda) as s:
            torch.ones(1 << 20, device=cuda).sum()
    tracing.take()
    assert s.device_ms is not None and s.device_ms > 0


def _launch_each(device):
    """One call of each kernel wrapper on small inputs on ``device``, with
    the tracer's launch counters it raises: its own, and K1's inside K3."""
    from lapgnn_tpu_torch.ops import cuda as kernels
    from lapgnn_tpu_torch.ops import sinkhorn as tsink
    from lapgnn_tpu_torch.ops.sentinels import clip_cost_sentinels

    n = 64
    C = torch.from_numpy(_cost("uniform", n, 3))
    u = C.amin(1)
    v = (C - u[:, None]).amin(0)
    tight = (C - u[:, None] - v[None, :]).abs() <= 1e-5
    counts = torch.zeros(5, dtype=torch.int64)
    # the plain versions make S2's and S1's states
    x, y = kernels.greedy_match(tight, counts[0:1])
    after_arr = kernels.arr_auction(C, x, y, v, 64, 0.0, counts[1:2])
    on = lambda t: t.to(device).contiguous()  # noqa: E731
    Cd, ud, vd, td, xd, yd, counts = map(on, (C, u, v, tight, x, y, counts))
    after_arr = tuple(map(on, after_arr))
    B1 = on(C[None])
    red = on(B1 - ud[None, :, None])
    order = on(torch.argsort(red.amin(-1), dim=-1, stable=True))
    cost_r = on(clip_cost_sentinels(B1))
    scale = on(tsink._robust_scale(cost_r))
    edge = [torch.randn(*shape, device=device)
            for shape in ((1, 9, 9, 10), (128, 10), (128,), (128, 128), (128,), (128, 8), (8,))]
    return {
        "col_min": (lambda: kernels.col_min(Cd), {"col_min"}),
        "min_trick": (lambda: kernels.min_trick(Cd, ud), {"min_trick"}),
        "row_features_stats": (lambda: kernels.row_features_stats(Cd),
                               {"row_features_stats", "col_min"}),
        "two_min": (lambda: kernels.two_min(Cd, vd), {"two_min"}),
        "greedy_total": (lambda: kernels.greedy_total(red, B1, order), {"greedy_total"}),
        "greedy_match": (lambda: kernels.greedy_match(td, counts[0:1]), {"greedy_match"}),
        "arr_auction": (lambda: kernels.arr_auction(Cd, xd, yd, vd, 64, 0.0, counts[1:2]),
                        {"arr_auction"}),
        "augment_sweep": (lambda: kernels.augment_sweep(Cd, *after_arr, counts[2:]),
                          {"augment_sweep"}),
        "sinkhorn_ladder": (lambda: kernels.sinkhorn_ladder(
            cost_r, B1, on(ud[None]), scale, list(tsink.DEFAULT_EPS_SCHEDULE),
            tsink.DEFAULT_ITERS_PER_EPS), {"sinkhorn_ladder"}),
        "dual_edge_terms": (lambda: kernels.dual_edge_terms(*edge), {"dual_edge_terms"}),
    }


def test_cpu_calls_count_no_launch():
    """On the CPU every wrapper takes its plain version (``dual_edge_terms``
    has none and raises) and no launch counter moves."""
    calls = _launch_each(torch.device("cpu"))
    before = tracing.counters()
    for name, (call, _) in calls.items():
        if name == "dual_edge_terms":
            with pytest.raises(ValueError, match="unsupported device cpu"):
                call()
        else:
            call()
    after = tracing.counters()
    assert {k: v for k, v in after.items() if k.startswith("launch.")} == {
        k: v for k, v in before.items() if k.startswith("launch.")}


@pytest.mark.cuda
def test_each_launch_counts_once_on_the_card(cuda):
    """Each of the ten kernel wrappers raises its tracer counter
    ``launch.<wrapper>`` by exactly one a launch, and no other counter but
    K1's inside K3; ``host_syncs`` does not move."""
    calls = _launch_each(cuda)
    assert len(calls) == 10
    for name, (call, raised) in calls.items():
        call()  # builds the kernel
        torch.cuda.synchronize()
        before = tracing.counters()
        call()
        torch.cuda.synchronize()
        after = tracing.counters()
        moved = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
        assert moved == {f"launch.{k}": 1 for k in raised}, name


def _syncs_by_call(calls):
    """Each call under warn mode with the tracer on: its spans, and each sync
    warning raised during it with the ids of the spans open then and its
    call site.  Warn mode is on around all the calls, not switched per call."""
    seen = []

    def show(message, category, filename, lineno, *args, **kwargs):
        if "synchroniz" in str(message):
            seen.append(({s.id for s in tracing._stack()}, f"{Path(filename).name}:{lineno}"))

    torch.cuda.synchronize()
    out = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for call in calls:
                first = len(seen)
                with tracing.record():
                    call()
                out.append((tracing.take(), seen[first:]))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["solve", "train"])
def test_host_syncs_equal_warn_mode_on_the_card(cuda, path):
    """Each span's ``host_syncs`` rise is the number of syncs warn mode
    reports while it is open, and a call's root holds all of the call's."""
    if path == "solve":
        params, meta, _ = load_checkpoint(CKPT)
        pipe = WarmStartPipeline(build_model_from_meta(meta), params, device=cuda)
        costs = [_cost(f, n, 8) for n in (1280, 2048) for f in ("uniform", "sparse", "tie")]
        calls = [lambda C=C: pipe.solve(C) for C in costs]
        root = "lapgnn.solve"
    else:
        model = build_dual_gnn(16, 2, 2, 0.1, seed=3, device=cuda)
        opt = make_optimizer(list(model.parameters()), 1e-3, 1e-4, 1.0)
        step = make_dual_train_step(model, opt)
        cost = torch.from_numpy(np.stack([_cost(f, 64, 7) for f in ("uniform", "sparse")]))
        cost = cost.to(cuda)
        # a generator on the card: each layer's dropout seed is a host read
        gen = torch.Generator(device=cuda).manual_seed(5)
        calls = [lambda: step(cost, cost.amin(-1), gen)] * 3
        root = "lapgnn.train.step"
    for call in calls:  # builds the kernels
        call()
    for spans, warned in _syncs_by_call(calls):
        rows = [(s.name, s.counts("host_syncs"), sum(s.id in ids for ids, _ in warned))
                for s in spans]
        assert [row for row in rows if row[1] != row[2]] == [], (rows, warned)
        assert [count for name, count, _ in rows if name == root] == [len(warned)], (rows, warned)
        assert warned


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["off", "f32"])
def test_curriculum_step_syncs_equal_warn_mode_on_the_card(cuda, cache, monkeypatch):
    """A call of ``progressive.BatchStepper`` (the fetch, OneGNN's train step,
    the readback) at n = 64 with the cache and readback gates lowered to it:
    each span's ``host_syncs`` rise is the number of syncs warn mode reports
    while it is open, and the counter's rise over the call, which its root
    span ``lapgnn.train.call`` reads, is every sync of the call (the fetch's
    copies and the readback)."""
    monkeypatch.setattr(progressive, "DEVICE_CACHE_MIN_N", 64)
    monkeypatch.setattr(progressive, "SYNC_MIN_N", 64)
    model = build_one_gnn(16, 2, 0.1, 4, seed=3, device=cuda)
    opt = make_optimizer(trainable_parameters(model, True), 1e-3, 1e-4, 1.0)
    step = make_train_step(model, opt, True, normalize_gap=True, normalize_costs=True)
    costs = [_cost(f, 64, k) for k, f in enumerate(("uniform", "sparse", "tie", "uniform"))]
    spec = progressive.DatasetSpec("n64", 64, [{"cost": C, "u": C.min(1)} for C in costs])
    stepper = progressive.BatchStepper(step, cuda, [spec], cache)
    gen = torch.Generator(device=cuda).manual_seed(5)
    calls = [lambda: stepper(spec, np.array([3, 1]), gen)] * 3
    rises = []

    def counted(call):
        before = tracing.counters()["host_syncs"]
        call()
        rises.append(tracing.counters()["host_syncs"] - before)

    for call in calls:  # builds the greedy kernel
        call()
    by_call = _syncs_by_call([lambda call=call: counted(call) for call in calls])
    assert rises == [(1 if cache == "f32" else 2) + 1] * 3
    for (spans, warned), rise in zip(by_call, rises):
        rows = [(s.name, s.counts("host_syncs"), sum(s.id in ids for ids, _ in warned))
                for s in spans]
        assert [row for row in rows if row[1] != row[2]] == [], (rows, warned)
        assert rise == len(warned), (rows, warned)
        assert [count for name, count, _ in rows if name == "lapgnn.train.call"] == [rise]


@pytest.mark.cuda
@pytest.mark.parametrize("fam", ["uniform", "sparse", "tie"])
def test_solve_sync_counts_on_the_card(cuda, fam):
    """At n = 2048 a default ``solve(C)`` makes two host syncs, the upload
    and the readback: the predict makes none (its constants are made on the
    card, and the Sinkhorn ladder is one kernel whose temperatures are made
    there), whether it runs eagerly (the first call of its shape) or from
    its graphs (the second captures them, the third replays)."""
    params, meta, _ = load_checkpoint(CKPT)
    pipe = WarmStartPipeline(build_model_from_meta(meta), params, device=cuda)
    C = _cost(fam, 2048, 8)
    for served in ("eager", "capture", "replay"):
        with tracing.record():
            pipe.solve(C)
        spans = tracing.take()
        counts = {s.name: s.counts("host_syncs") for s in spans}
        predict = next(s for s in spans if s.name == "lapgnn.predict")
        assert predict.counts(f"predict_graph.{served}") == 1, served
        assert counts["lapgnn.predict"] == 0, served
        assert counts["lapgnn.solve"] == 2, served


@pytest.mark.cuda
@pytest.mark.parametrize("timed", [False, True])
def test_stage_spans_take_events_only_when_timed(cuda, timed):
    C = torch.from_numpy(_cost("uniform", 256, 5)).to(cuda)
    u = C.amin(1)
    v = (C - u[:, None]).amin(0)
    with tracing.record():
        lapjv_seeded_single(C, u, v, stats=SolveStats(timed=timed))
    spans = {s.name: s for s in tracing.take()}
    assert spans["lapgnn.seeded"].device_ms is not None
    for stage in STAGES:
        assert (spans[f"lapgnn.seeded.{stage}"].device_ms is not None) == timed, stage
