"""OneGNN's progressive training step against the benchmark's plain
reference (``lapbench/reference/one_gnn.py``) and through its seam
(``train.progressive.BatchStepper``), on the CPU at a small size: u, the
loss, every gradient leaf and the parameters after two AdamW steps on seeded
random weights with dropout on; ``train_progressive`` through the seam equal
to its per-batch body as it was written inline; the seam's spans and the
host syncs it counts.  Imports no JAX."""

import json
import statistics
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lapgnn_tpu_torch import tracing
from lapgnn_tpu_torch.train import checkpoint as tckpt
from lapgnn_tpu_torch.train import progressive as tprog
from lapgnn_tpu_torch.train.schedule import make_optimizer
from lapgnn_tpu_torch.train.trainer import (build_one_gnn, loss_and_grads, make_train_step,
                                            model_params, trainable_parameters)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from lapbench.entries.one_train_step import _flax_name  # noqa: E402
from lapbench.reference.dual_gnn import greedy_upper  # noqa: E402
from lapbench.reference.one_gnn import Reference  # noqa: E402

N, B, HIDDEN, LAYERS, TOPK, RATE, LR = 48, 4, 16, 2, 8, 0.1, 1e-3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _as_flax(name, t):
    """A port leaf in flax's layout: a Linear's weight is the kernel's
    transpose."""
    t = t.detach()
    return t.T if name.endswith("/kernel") else t


def _setup(seed):
    model = build_one_gnn(HIDDEN, LAYERS, RATE, TOPK, False, seed, "cpu")
    params = _flat(model_params(model, True)["params"])
    opt = make_optimizer(trainable_parameters(model, True), LR, 1e-4, 1.0)
    names = [_flax_name(n) for n, _ in model.named_parameters()]
    g = torch.Generator().manual_seed(100 + seed)
    costs = [torch.rand(B, N, N, generator=g) for _ in range(2)]
    targets = [c.amin(-1) + 0.1 * torch.rand(B, N, generator=g) for c in costs]
    ref = Reference(params, LAYERS, TOPK, RATE, LR, 1e-4, 1.0, torch.device("cpu"), greedy_upper)
    return model, opt, names, costs, targets, ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_step_equals_the_reference(seed):
    """u, the loss and every gradient leaf of one step, dropout on.  Both
    sides make the same float32 operations on the CPU, but the products'
    summation order may differ (``x @ kernel`` against ``F.linear``), so
    each is held within 1e-5 of its scale: u and the loss relative, a leaf
    against the larger of its own largest entry and the median leaf's (the
    head's last bias has a gradient of rounding size: the gauge cancels
    it)."""
    model, opt, names, costs, targets, ref = _setup(seed)
    outs = []
    hook = model.register_forward_hook(lambda m, a, o: outs.append(o["u"].detach().clone()))
    loss, _, grads = loss_and_grads(model, opt.params, costs[0], targets[0], True, True, True, True,
                                    torch.Generator().manual_seed(7))
    hook.remove()
    parts, ref_grads = ref.loss_and_grads(costs[0], targets[0], torch.Generator().manual_seed(7))
    u_ref = parts["out"][:, N:]
    assert (outs[0] - u_ref).abs().max() <= 1e-5 * u_ref.abs().max()
    assert abs(loss.item() - parts["loss"]) <= 1e-5 * abs(parts["loss"])
    assert set(names) == set(ref_grads)
    floor = statistics.median(float(g.abs().max()) for g in ref_grads.values())
    for name, g in zip(names, grads):
        want = ref_grads[name]
        scale = max(float(want.abs().max()), floor)
        assert float((_as_flax(name, g) - want).abs().max()) <= 1e-5 * scale, name


@pytest.mark.parametrize("seed", [0, 3])
def test_two_adamw_steps_equal_the_reference(seed):
    """The parameters after two steps through ``make_train_step``.  The
    optimizer's arithmetic is the same, in another order (optax's
    ``p - lr * (adam + wd * p)`` against the port's foreach ops), so each
    entry is held within 1e-6, a few float32 ulps of weights of order one.
    The head's last bias is held to 2 lr: its gradient is rounding noise,
    which Adam's normalisation turns into steps of up to lr either way."""
    model, opt, names, costs, targets, ref = _setup(seed)
    step = make_train_step(model, opt, True, True, True, True)
    gen = torch.Generator().manual_seed(7)
    for cost, u in zip(costs, targets):
        step(cost, u, gen)
    ref.steps(list(zip(costs, targets)), 7)
    for name, p in zip(names, opt.params):
        tol = 2 * LR if name == "head_fc2/bias" else 1e-6
        assert float((_as_flax(name, p) - ref.p[name]).abs().max()) <= tol, name


def _records(fam, n, count, seed):
    from lapgnn_tpu_torch.data.synthetic import generate_synthetic_instance, instance_record

    rng = np.random.default_rng(seed)
    return [instance_record(generate_synthetic_instance(fam, n, rng)) for _ in range(count)]


class _InlineBody:
    """The per-batch body of ``train_progressive`` as it was written inline
    before the seam: the device cache built in place, each batch gathered
    or stacked and uploaded, the step, the loss read back at
    ``SYNC_MIN_N``."""

    calls = 0

    def __init__(self, train_step, dev, specs, cache_mode):
        self.train_step, self.dev, self.caches = train_step, dev, {}
        if cache_mode != "off":
            cdt = torch.bfloat16 if cache_mode == "bf16" else torch.float32
            for s in specs:
                if s.size < tprog.DEVICE_CACHE_MIN_N:
                    continue
                Cc = torch.from_numpy(tprog._stack_f32(s.instances, "cost")).to(dev).to(cdt)
                Uc = torch.from_numpy(tprog._stack_f32(s.instances, "u")).to(dev)
                self.caches[id(s)] = (Cc, Uc)

    def __call__(self, spec, idx, dropout_gen):
        type(self).calls += 1
        if id(spec) in self.caches:
            Cc, Uc = self.caches[id(spec)]
            ib = torch.from_numpy(np.asarray(idx, np.int64)).to(self.dev)
            cost_d = Cc.index_select(0, ib).to(torch.float32)
            u_d = Uc.index_select(0, ib)
        else:
            cost, u = tprog.RoundRobinSampler.materialize(spec, idx)
            cost_d, u_d = torch.from_numpy(cost).to(self.dev), torch.from_numpy(u).to(self.dev)
        m = self.train_step(cost_d, u_d, dropout_gen)
        return m["loss"].item() if spec.size >= tprog.SYNC_MIN_N else m["loss"]


@pytest.fixture(scope="module")
def curriculum():
    return {"a": (_records("uniform", 16, 6, 0), _records("uniform", 16, 3, 1)),
            "b": (_records("noisy_linear", 24, 4, 2), _records("noisy_linear", 24, 2, 3))}


def _config(tmp, cache):
    return {
        "model": {"hidden": 16, "layers": 2, "dropout": 0.1, "topk": 4,
                  "use_cost_refinement": True},
        "loss": {"normalize_gap": True, "normalize_costs": True},
        "optimizer": {"lr": 3e-3, "weight_decay": 1e-4, "grad_clip": 1.0, "warmup_frac": 0.2,
                      "min_lr": 1e-5},
        "sampling": {"batches_per_size": 2},
        "training": {"epochs": 2, "min_epochs": 1, "patience": 4, "seed": 19,
                     "device_cache": cache},
        "checkpointing": {"output_dir": str(tmp)},
    }


@pytest.mark.parametrize("cache", ["off", "bf16", "f32"])
def test_train_progressive_through_the_seam_is_unchanged(tmp_path, curriculum, cache, monkeypatch):
    """Two epochs over sizes 16 and 24, dropout on, the cache and readback
    gates lowered so that size 24 is cached (under bf16 / f32) and read back
    each step: the same logs, losses, validation gaps and checkpoints, bit
    for bit, as the body written inline; each batch goes through the
    seam."""
    monkeypatch.setattr(tprog, "DEVICE_CACHE_MIN_N", 24)
    monkeypatch.setattr(tprog, "SYNC_MIN_N", 24)
    specs = [tprog.DatasetSpec("a", 16, curriculum["a"][0], val_instances=curriculum["a"][1]),
             tprog.DatasetSpec("b", 24, curriculum["b"][0], val_instances=curriculum["b"][1])]
    monkeypatch.setattr(_InlineBody, "calls", 0)
    seam_calls = []
    call = tprog.BatchStepper.__call__
    monkeypatch.setattr(tprog.BatchStepper, "__call__",
                        lambda self, *a: seam_calls.append(1) or call(self, *a))
    runs = {}
    for name in ("seam", "inline"):
        if name == "inline":
            monkeypatch.setattr(tprog, "BatchStepper", _InlineBody)
        logs = []
        best, hist = tprog.train_progressive(_config(tmp_path / name, cache), specs,
                                             log_fn=logs.append, device="cpu")
        runs[name] = ([line.split(" (")[0] for line in logs], best, hist)
    assert len(seam_calls) == _InlineBody.calls > 0
    assert runs["seam"][0] == runs["inline"][0]
    assert any(line.startswith("device-cached b") for line in runs["seam"][0]) == (cache != "off")
    assert runs["seam"][2] == runs["inline"][2]
    for leaf_a, leaf_b in zip(_flat(runs["seam"][1]).values(), _flat(runs["inline"][1]).values()):
        np.testing.assert_array_equal(leaf_a, leaf_b)
    for d in ("best", "last"):
        a, ma, _ = tckpt.load_checkpoint(tmp_path / "seam" / d)
        b, mb, _ = tckpt.load_checkpoint(tmp_path / "inline" / d)
        assert {**ma, "config": 0} == {**mb, "config": 0}
        for leaf_a, leaf_b in zip(_flat(a).values(), _flat(b).values()):
            np.testing.assert_array_equal(leaf_a, leaf_b)
    last = json.loads((tmp_path / "seam" / "last" / "meta.json").read_text())
    assert last["config"]["training"]["device_cache"] == cache


ONE_TRAIN = {"lapgnn.train.step": None,
             **{f"lapgnn.train.{s}": "lapgnn.train.step"
                for s in ("normalize", "features", "forward", "loss", "backward", "optimizer")},
             "lapgnn.one.refine": "lapgnn.train.forward"}


@pytest.mark.parametrize("cached", [False, True])
def test_the_seam_spans_and_host_syncs(cached, monkeypatch):
    """A call of the seam: the root ``lapgnn.train.call`` holds the fetch
    (``lapgnn.train.batch``), then the step's tree with the refinement inside
    the forward, then the readback; ``host_syncs`` counts the fetch's copies
    (the index upload, or the two uploads) and the readback, each inside the
    call: the step copies nothing (its positional code is made in place)."""
    monkeypatch.setattr(tprog, "DEVICE_CACHE_MIN_N", N)
    monkeypatch.setattr(tprog, "SYNC_MIN_N", N)
    model, opt, _, costs, targets, _ = _setup(5)
    step = make_train_step(model, opt, True, True, True, True)
    records = [{"cost": c.numpy(), "u": u.numpy()} for c, u in zip(costs[0], targets[0])]
    spec = tprog.DatasetSpec("n48", N, records)
    stepper = tprog.BatchStepper(step, torch.device("cpu"), [spec], "f32" if cached else "off")
    assert (id(spec) in stepper.caches) == cached
    tracing.take()
    before = tracing.counters()["host_syncs"]
    with tracing.record():
        loss = stepper(spec, np.array([2, 0, 3]), torch.Generator().manual_seed(1))
    spans = tracing.take()
    assert isinstance(loss, float)
    fetch = 1 if cached else 2
    assert tracing.counters()["host_syncs"] - before == fetch + 1
    by_id = {s.id: s for s in spans}
    call = [s for s in spans if s.name == "lapgnn.train.call"]
    assert len(call) == 1 and call[0].parent is None
    assert call[0].counts("host_syncs") == fetch + 1
    tree = {"lapgnn.train.call": None, "lapgnn.train.batch": "lapgnn.train.call",
            **ONE_TRAIN, "lapgnn.train.step": "lapgnn.train.call"}
    assert sorted(s.name for s in spans) == sorted(tree)
    for s in spans:
        assert (by_id[s.parent].name if s.parent else None) == tree[s.name], s.name
        assert s.request == call[0].request
    batch = next(s for s in spans if s.name == "lapgnn.train.batch")
    assert batch.counts("host_syncs") == fetch
    root = next(s for s in spans if s.name == "lapgnn.train.step")
    assert root.counts("host_syncs") == 0
