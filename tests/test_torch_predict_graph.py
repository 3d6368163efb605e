"""Predict served from CUDA graphs (``graphs``, ``pipeline.predict_duals_fn``).

On the CPU: the predict's constants (the positional frequencies, the
quantile positions, the exact division's divisor) are made where they are
used, bit-equal to the copies they replace and with no ``host_syncs``; a
CPU or float64 predict runs eagerly, counted in ``predict_graph.eager``, and
gives the eager chain's pair; the capture and the replay, with the card
stood in for, cut at every span, take back the counts of the capture, and
give them and the spans back on each replay; ``GraphedCall`` runs a key
eagerly, then captures, then replays, keeps four keys, returns clones,
raises a failed capture and tries it again, serves threads one at a time
and has each call wait on the card for the last call of its key.

On the card (``cuda``; this file imports no JAX): OneGNN
(``one_gnn_default``) and DualGNN (``dual_gnn_r5``, whose predict runs
eagerly: its graphs are called directly) at (1, 2048) on the serving
families are bit-equal, replay against eager; a predict makes no sync
under ``torch.cuda.set_sync_debug_mode("error")``; a capture records, and
so each replay adds, every ``launch.*`` rise of an eager call, and
``host_syncs`` not at all; the returned pair survives the next call; a
fifth key evicts the oldest; a DualGNN's predict runs eagerly, so a
``forward`` set on its instance sees every call.
"""

import contextlib
import math
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from lapgnn_tpu_torch import graphs, tracing
from lapgnn_tpu_torch.data.generators import FAMILIES
from lapgnn_tpu_torch.ops import features as tfeat
from lapgnn_tpu_torch.ops import sinkhorn as tsink
from lapgnn_tpu_torch.ops.dual import robust_normalize
from lapgnn_tpu_torch.ops.features import fast_row_features, graph_features
from lapgnn_tpu_torch.ops.sinkhorn import auto_select_seed
from lapgnn_tpu_torch.pipeline import WarmStartPipeline, predict_duals_fn
from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint

ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"
SERVED = ["uniform", "noisy_linear", "sparse", "tie"]  # the serving cells' families
DUAL_META = {"architecture": "dual_gnn", "hidden": 32, "layers": 2, "heads": 4,
             "dropout": 0.1, "node_feat_dim": 14, "edge_feat_dim": 10}


def _cost(fam, n, seed):
    return FAMILIES[fam](n, np.random.default_rng(seed)).astype(np.float32)


def _syncs():
    return tracing.counters()["host_syncs"]


def _moved(before, after):
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


# --- the constants, made where they are used ----------------------------------


def _positional_by_copy(n):
    """``positional_encodings`` as it was: the frequencies copied from the host."""
    pos = torch.arange(n, dtype=torch.float32).reshape(n, 1)
    freqs = torch.tensor(tfeat.POS_FREQS, dtype=torch.float32).reshape(1, -1)
    angle = 2.0 * math.pi * pos * freqs / float(max(1, n - 1))
    return torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1).reshape(n, -1)


def _quantiles_by_copy(a, qs):
    """``_quantiles`` as it was: the positions copied to the device and the
    weights computed there."""
    m = a.shape[-1]
    a = torch.where(torch.isnan(a).any(-1, keepdim=True), torch.nan, a)
    srt = torch.sort(a, dim=-1).values
    pos = torch.tensor(qs, dtype=torch.float64) * float(m - 1)
    lo_i = torch.floor(pos).clamp(0, m - 1).long()
    hi_i = torch.ceil(pos).clamp(0, m - 1).long()
    hi_w = (pos - torch.floor(pos))[:, None]
    lo = srt[:, lo_i].T.to(torch.float64)
    hi = srt[:, hi_i].T.to(torch.float64)
    return (lo * (1.0 - hi_w) + hi * hi_w).to(a.dtype)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 2048])
def test_positional_encodings_bit_equal_with_no_copy(n):
    before = _syncs()
    got = tfeat.positional_encodings(n)
    assert _syncs() == before
    assert torch.equal(got, _positional_by_copy(n))


@pytest.mark.parametrize("qs", [(0.1, 0.9), (0.0, 0.5, 1.0), (0.25,), (0.333, 0.999)])
@pytest.mark.parametrize("m", [1, 2, 5, 97, 65536])
def test_quantiles_bit_equal_with_no_copy(qs, m):
    rng = np.random.default_rng(m)
    a = torch.from_numpy(rng.normal(size=(3, m)).astype(np.float32))
    a[1, m // 2] = float("nan")
    a[2, 0] = float("inf")
    before = _syncs()
    got = tsink._quantiles(a, qs)
    assert _syncs() == before
    want = _quantiles_by_copy(a, qs)
    assert got.shape == want.shape == (len(qs), 3)
    assert torch.equal(torch.nan_to_num(got, nan=7.0), torch.nan_to_num(want, nan=7.0))
    assert torch.isnan(got[:, 1]).all()


@pytest.mark.parametrize("d", [1, 3, 7, 10, 2047])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_exact_div_bit_equal_with_no_copy(d, dtype):
    x = torch.arange(4096, dtype=dtype) * 0.37
    before = _syncs()
    got = tfeat._exact_div(x, d)
    assert _syncs() == before
    assert got.dtype == dtype
    assert torch.equal(got, x / torch.tensor(float(d), dtype=dtype))


def test_graph_features_plain_makes_no_copy():
    C = torch.from_numpy(np.stack([_cost("tie", 17, 1), _cost("sparse", 17, 2)]))
    before = _syncs()
    tfeat.graph_features_plain(C)
    assert _syncs() == before


# --- predicts that stay eager ---------------------------------------------------


@pytest.fixture(scope="module")
def one_gnn():
    params, meta, _ = load_checkpoint(ARTIFACTS / "one_gnn_default")
    return WarmStartPipeline(build_model_from_meta(meta), params, device="cpu")


@pytest.fixture(scope="module")
def small_dual():
    torch.manual_seed(20)
    return build_model_from_meta(DUAL_META).eval()


def _eager_one_gnn(pipe, C):
    """The pipeline's default predict, written out: normalised costs, K3's
    plain row features, the model with cost refinement, the 'auto' seed."""
    cost_in, mn, a = robust_normalize(C)
    u = pipe.model(fast_row_features(cost_in), cost=cost_in)["u"]
    return auto_select_seed(C, u * a[..., None] + mn[..., None])


def _eager_dual(model, C):
    feats = graph_features(C)
    u = model(feats.edge_feat, feats.row_feat, feats.col_feat)["u"].to(C.dtype)
    return auto_select_seed(C, u)


@pytest.mark.parametrize("case", ["one_gnn_cpu_float32", "dual_cpu_float32",
                                  "dual_cpu_float64"])
def test_cpu_and_float64_predicts_run_eagerly(case, one_gnn, small_dual):
    dtype = torch.float64 if case.endswith("float64") else torch.float32
    C = torch.from_numpy(np.stack([_cost("noisy_linear", 24, 3), _cost("tie", 24, 4)]))
    C = C.to(dtype)
    if case.startswith("one_gnn"):
        predict, want_fn = one_gnn._predict, lambda: _eager_one_gnn(one_gnn, C)
    else:
        predict, want_fn = predict_duals_fn(small_dual), lambda: _eager_dual(small_dual, C)
    with torch.inference_mode():
        want = want_fn()
    for _ in range(3):  # no call of a CPU key is captured
        before = tracing.counters()
        got = predict(C)
        after = tracing.counters()
        assert after["predict_graph.eager"] - before["predict_graph.eager"] == 1
        assert after["predict_graph.replay"] == before["predict_graph.replay"]
        assert after["predict_graph.capture"] == before["predict_graph.capture"]
        for g, w in zip(got, want):
            assert g.dtype == dtype and torch.equal(g, w)
    assert predict.graphs.keys() == []


def test_rank1_seed_mode_runs_eagerly(one_gnn):
    predict = predict_duals_fn(one_gnn.model, seed_mode="rank1")
    before = tracing.counters()["predict_graph.eager"]
    predict(torch.from_numpy(_cost("uniform", 16, 1))[None])
    assert tracing.counters()["predict_graph.eager"] == before + 1


# --- capture and replay, the card stood in for ---------------------------------


class _FakeGraph:
    """A stand-in for ``torch.cuda.CUDAGraph``: capture runs the work
    eagerly on the CPU; a replay only counts."""

    made = []

    def __init__(self):
        self.replays, self.mode, self.ended = 0, None, False
        _FakeGraph.made.append(self)

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.mode = capture_error_mode

    def capture_end(self):
        self.ended = True

    def replay(self):
        self.replays += 1


_ORDER = []  # the fake streams' waits on events and the events' records


class _FakeStream:
    def __init__(self, name="side"):
        self.name = name

    def wait_stream(self, other):
        pass

    def wait_event(self, event):
        _ORDER.append(("wait", self.name, event.on))


class _FakeEvent:
    def __init__(self):
        self.on = None  # the stream of the last record

    def record(self, stream=None):
        self.on = stream.name
        _ORDER.append(("record", stream.name))


@pytest.fixture
def fake_card(monkeypatch):
    _FakeGraph.made = []
    _ORDER.clear()
    current = {"stream": _FakeStream("main")}
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: current["stream"])
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    _FakeGraph.current = current
    tracing.take()
    yield _FakeGraph
    tracing.take()


def _nested(x):
    with tracing.span("outer", x.device):
        y = x * 2
        with tracing.span("inner", x.device):
            tracing.count("launch.fake")
            z = y + 1
        tracing.count("launch.fake", 2)
    return (z, y)


def _unmoved(before):
    return _moved(before, tracing.counters()) == {}


def test_capture_cuts_at_spans_and_takes_back_its_counts(fake_card):
    x = torch.arange(4.0)
    before = tracing.counters()
    with tracing.record():
        rec = graphs.capture(lambda: _nested(x), torch.device("cpu"))
    assert tracing.take() == []  # the capture records no span
    assert _unmoved(before)
    marks = [s for s in rec.steps if not isinstance(s, graphs._Piece)]
    assert [m[:2] for m in marks] == [("open", "outer"), ("open", "inner"),
                                      ("close", "inner"), ("close", "outer")]
    pieces = [s for s in rec.steps if isinstance(s, graphs._Piece)]
    assert rec.graphs == len(pieces) == 5 == len(fake_card.made)
    assert [p.rise for p in pieces] == [[], [], [("launch.fake", 1)], [("launch.fake", 2)], []]
    assert all(g.ended and g.mode == "thread_local" for g in fake_card.made)
    assert torch.equal(rec.outputs[0], x * 2 + 1)


@pytest.mark.parametrize("traced", [False, True])
def test_replay_gives_back_the_spans_and_the_counts(fake_card, traced):
    x = torch.arange(4.0)
    rec = graphs.capture(lambda: _nested(x), torch.device("cpu"))
    before = tracing.counters()
    with tracing.record() if traced else contextlib.nullcontext():
        with tracing.span("root"):
            rec.replay()
    assert tracing.counters()["launch.fake"] - before.get("launch.fake", 0) == 3
    assert all(g.replays == 1 for g in fake_card.made)
    spans = {s.name: s for s in tracing.take()}
    if not traced:
        assert spans == {}
        return
    assert sorted(spans) == ["lapgnn.inner", "lapgnn.outer", "lapgnn.root"]
    assert spans["lapgnn.inner"].parent == spans["lapgnn.outer"].id
    assert spans["lapgnn.outer"].parent == spans["lapgnn.root"].id
    assert spans["lapgnn.inner"].counts("launch.fake") == 1
    assert spans["lapgnn.outer"].counts("launch.fake") == 3


def test_a_failed_capture_leaves_no_capture_open(fake_card):
    def broken():
        with tracing.span("outer"):
            tracing.count("launch.fake")
            raise RuntimeError("refused")

    before = tracing.counters()
    with pytest.raises(RuntimeError, match="refused"):
        graphs.capture(broken, torch.device("cpu"))
    assert all(g.ended for g in fake_card.made)
    assert _unmoved(before)
    with tracing.span("after"):  # spans are spans again
        pass


def _counting(calls):
    def fn(x):
        calls.append(tuple(x.shape))
        return _nested(x)

    return fn


def _counts():
    c = tracing.counters()
    return tuple(c[f"g.{k}"] for k in ("eager", "capture", "replay"))


def test_graphed_call_runs_eagerly_then_captures_then_replays(fake_card):
    calls = []
    call = graphs.GraphedCall(_counting(calls), "g")
    x = torch.arange(6.0).reshape(2, 3)
    start = np.array(_counts())
    outs = [call(x) for _ in range(4)]
    assert calls == [(2, 3), (2, 3)]  # the eager call and the capture
    assert tuple(np.array(_counts()) - start) == (1, 1, 3)
    assert call.keys() == [((2, 3), torch.float32, torch.device("cpu"))]
    for out in outs:
        assert torch.equal(out[0], x * 2 + 1) and torch.equal(out[1], x * 2)
    # the replays' outputs are clones the caller owns
    rec = call._keys[call.keys()[0]].recording
    assert all(o.data_ptr() != r.data_ptr() for o in outs[1:] for o, r in zip(o, rec.outputs))
    outs[2][0].fill_(-1.0)
    assert torch.equal(call(x)[0], x * 2 + 1)


def test_graphed_call_keeps_four_keys(fake_card):
    calls = []
    call = graphs.GraphedCall(_counting(calls), "g")
    xs = [torch.zeros(1, n) for n in range(1, 6)]
    for x in xs[:4]:
        call(x)
        call(x)
    assert [k[0] for k in call.keys()] == [(1, 1), (1, 2), (1, 3), (1, 4)]
    call(xs[0])  # the oldest is now the most recently used
    call(xs[4])  # a fifth key evicts the least recently used, (1, 2)
    assert [k[0] for k in call.keys()] == [(1, 3), (1, 4), (1, 1), (1, 5)]
    before = np.array(_counts())
    call(xs[1])  # evicted: eager again, as a new key
    assert tuple(np.array(_counts()) - before) == (1, 0, 0)
    assert [k[0] for k in call.keys()] == [(1, 4), (1, 1), (1, 5), (1, 2)]


@pytest.mark.parametrize("where", ["outside_spans", "in_a_span"])
def test_graphed_call_raises_a_failed_capture(fake_card, where):
    """A capture that fails raises to the caller, counts nothing, leaves no
    capture open, and the next call of the key tries again."""
    state = {"calls": 0}

    def fn(x):
        state["calls"] += 1
        if state["calls"] == 2:
            if where == "in_a_span":
                with tracing.span("outer"):
                    tracing.count("launch.fake")
                    raise RuntimeError("not capturable")
            raise RuntimeError("not capturable")
        return (x + 1,)

    call = graphs.GraphedCall(fn, "g")
    x = torch.ones(3)
    call(x)
    start, before = np.array(_counts()), tracing.counters()
    with pytest.raises(RuntimeError, match="not capturable"):
        call(x)
    assert all(g.ended for g in fake_card.made)
    assert _moved(before, tracing.counters()) == {}
    assert call._keys[call.keys()[0]] is None  # not captured
    assert torch.equal(call(x)[0], x + 1)  # captured now, and replayed
    assert tuple(np.array(_counts()) - start) == (0, 1, 1)
    assert state["calls"] == 3


def test_graphed_call_waits_while_another_thread_holds_it(fake_card):
    call = graphs.GraphedCall(lambda x: (x + 1,), "g")
    x = torch.ones(2)
    call(x)
    call(x)  # captured
    before = np.array(_counts())
    done, out = threading.Event(), []

    def other():
        out.append(call(x))
        done.set()

    with call._lock:
        t = threading.Thread(target=other)
        t.start()
        assert not done.wait(0.2)  # it waits for the lock, and runs nothing eagerly
        assert tuple(np.array(_counts()) - before) == (0, 0, 0)
    t.join(timeout=10)
    assert done.is_set() and torch.equal(out[0][0], x + 1)
    assert tuple(np.array(_counts()) - before) == (0, 0, 1)


@pytest.mark.parametrize("streams", ["one_stream", "two_streams"])
def test_graphed_call_waits_for_the_last_replay_of_its_key(fake_card, streams):
    """Each replay waits on the event the last replay of its key recorded
    after its clones, on whatever stream that ran, before it writes the
    key's input buffer; and records it again on its own stream."""
    call = graphs.GraphedCall(lambda x: (x + 1,), "g")
    x = torch.ones(2)
    call(x)  # eager: no wait, no record
    assert _ORDER == []
    call(x)  # captured and replayed on main
    if streams == "two_streams":
        fake_card.current["stream"] = _FakeStream("other")
    call(x)
    second = "other" if streams == "two_streams" else "main"
    assert _ORDER == [("wait", "main", None), ("record", "main"),
                      ("wait", second, "main"), ("record", second)]


def test_graphed_call_loses_no_call_across_threads(fake_card):
    """More threads than cores, switching often, over five shapes: every
    call is served once (eagerly or by a replay), one at a time, right, and
    at most four keys stay."""
    import os
    import sys
    import threading

    call = graphs.GraphedCall(lambda x: (x * 2,), "g")
    xs = [torch.full((1, n), float(n)) for n in range(1, 6)]
    threads, each = 2 * (os.cpu_count() or 4), 200
    wrong = []
    start = np.array(_counts())
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(each):
                x = xs[(k + i) % len(xs)]
                if not torch.equal(call(x)[0], x * 2):
                    wrong.append((k, i))

        pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    eager, captures, replays = np.array(_counts()) - start
    assert wrong == []
    assert eager + replays == threads * each
    assert captures <= replays and len(call.keys()) <= graphs.GraphedCall.KEEP


# --- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _card_pipe(kind, cuda):
    name = {"one_gnn": "one_gnn_default", "dual_gnn": "dual_gnn_r5"}[kind]
    params, meta, _ = load_checkpoint(ARTIFACTS / name)
    return WarmStartPipeline(build_model_from_meta(meta), params, device=cuda,
                             normalize_costs=kind == "one_gnn")


def _card_predict(kind, cuda):
    return _card_pipe(kind, cuda)._predict


def _served(kind, predict):
    """What replays a kind's predict: a OneGNN's predict itself; for a
    DualGNN, whose predict runs eagerly, its graphs, called as the predict
    calls them."""
    if kind == "one_gnn":
        return predict

    @torch.inference_mode()
    def call(C):
        with tracing.span("predict", C.device):
            return predict.graphs(C)

    return call


def _on(cuda, C):
    return torch.from_numpy(C).to(cuda)[None]


def _launches():
    return {k: v for k, v in tracing.counters().items() if k.startswith("launch.")}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["one_gnn", "dual_gnn"])
def test_replay_is_bit_equal_to_eager_on_the_card(cuda, kind):
    predict = _card_predict(kind, cuda)
    served = _served(kind, predict)
    costs = {f: _on(cuda, _cost(f, 2048, 40 + k)) for k, f in enumerate(SERVED)}
    served(costs["uniform"])  # eager: builds the kernels
    served(costs["uniform"])  # captures
    with torch.inference_mode():
        for fam, C in costs.items():
            want = predict.graphs.eager(C)
            before = tracing.counters()["predict_graph.replay"]
            got = served(C)
            assert tracing.counters()["predict_graph.replay"] == before + 1
            for g, w in zip(got, want):
                assert torch.equal(g, w), fam
            u, v = got
            assert float((C[0] - u[0][:, None] - v[0][None, :]).amin()) >= 0.0, fam


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["one_gnn", "dual_gnn"])
def test_predict_makes_no_sync_on_the_card(cuda, kind):
    predict = _card_predict(kind, cuda)
    served = _served(kind, predict)
    C = _on(cuda, _cost("noisy_linear", 1024, 5))
    other = _on(cuda, _cost("tie", 512, 6))
    served(C)  # eager, outside the mode: builds the kernels
    served(other[..., :256, :256].contiguous())  # and the smaller shapes' paths
    torch.cuda.synchronize()
    before = _syncs()
    torch.cuda.set_sync_debug_mode("error")
    try:
        served(C)  # captures
        served(C)  # replays
        served(other)  # a new key: eager
        predict(C)  # the predict as it is served
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _syncs() == before
    assert len(predict.graphs.keys()) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["one_gnn", "dual_gnn"])
def test_capture_and_replay_count_the_eager_launches(cuda, kind):
    """The capture holds what the captured call counted, and each replay
    adds it: so the capture must have seen every launch an eager call
    makes, no more, and no host sync."""
    predict = _card_predict(kind, cuda)
    served = _served(kind, predict)
    C = _on(cuda, _cost("sparse", 2048, 7))
    rises = {}
    for step in ("eager", "capture", "replay", "replay_again"):
        torch.cuda.synchronize()
        before, syncs = _launches(), _syncs()
        served(C)
        torch.cuda.synchronize()
        rises[step] = _moved(before, _launches())
        assert _syncs() == syncs, step
    assert rises["eager"] and all(v > 0 for v in rises["eager"].values())
    for step in ("capture", "replay", "replay_again"):
        assert rises[step] == rises["eager"], step


@pytest.mark.cuda
def test_returned_duals_survive_the_next_call(cuda):
    predict = _card_predict("one_gnn", cuda)
    C1 = _on(cuda, _cost("uniform", 1024, 8))
    C2 = _on(cuda, _cost("tie", 1024, 9))
    predict(C1)
    predict(C1)  # captured
    u1, v1 = predict(C1)
    keep = (u1.clone(), v1.clone())
    u2, v2 = predict(C2)
    torch.cuda.synchronize()
    assert torch.equal(u1, keep[0]) and torch.equal(v1, keep[1])
    assert not torch.equal(u1, u2)
    with torch.inference_mode():  # the caller may change what it owns
        u1.add_(1.0)
    assert torch.equal(predict(C1)[0], keep[0])


@pytest.mark.cuda
def test_dual_gnn_predict_stays_eager_on_the_card(cuda):
    """A DualGNN's predict runs eagerly on every call of a shape, so a
    ``forward`` set on the model's instance (as a caller that keeps each
    call's u does) sees every call, and its graphs are never captured."""
    pipe = _card_pipe("dual_gnn", cuda)
    predict, model = pipe._predict, pipe.model
    C = _on(cuda, _cost("noisy_linear", 512, 10))
    want = predict(C)
    seen = []
    forward = model.forward

    def kept(*args, **kwargs):
        out = forward(*args, **kwargs)
        seen.append(out["u"].clone())
        return out

    model.forward = kept
    try:
        before = tracing.counters()
        got = [predict(C) for _ in range(3)]
        after = tracing.counters()
    finally:
        del model.forward
    assert len(seen) == 3
    assert after["predict_graph.eager"] - before["predict_graph.eager"] == 3
    assert _moved(before, after).keys().isdisjoint({"predict_graph.replay",
                                                    "predict_graph.capture"})
    assert predict.graphs.keys() == []
    for g in got:
        assert all(torch.equal(a, b) for a, b in zip(g, want))


@pytest.mark.cuda
def test_a_fifth_key_evicts_the_oldest_on_the_card(cuda):
    predict = _card_predict("one_gnn", cuda)
    sizes = (256, 320, 384, 448, 512)
    costs = [_on(cuda, _cost("uniform", n, n)) for n in sizes]
    for C in costs[:4]:
        predict(C)
        predict(C)  # captured
    assert [k[0] for k in predict.graphs.keys()] == [(1, n, n) for n in sizes[:4]]
    predict(costs[4])
    assert [k[0] for k in predict.graphs.keys()] == [(1, n, n) for n in sizes[1:]]
    before = tracing.counters()
    predict(costs[0])  # evicted: eager again
    after = tracing.counters()
    assert after["predict_graph.eager"] - before["predict_graph.eager"] == 1
    assert after["predict_graph.capture"] == before["predict_graph.capture"]
