"""Progressive multi-size curriculum training.

Port of ``lapgnn_tpu/train/progressive.py`` (``BATCH_SIZE_RULES`` :37,
``DEVICE_CACHE_MIN_N`` :42, ``SYNC_MIN_N`` :48, ``default_batch_size`` :51,
``DatasetSpec`` :59, ``RoundRobinSampler`` :68, ``train_progressive`` :147):
  * datasets become active at their curriculum epoch and take turns,
    ``batches_per_size`` batches each (scaled by their weight), with
    size-dependent batch sizes; smaller datasets reshuffle when they run out,
    and the largest one paces the epoch;
  * the OneGNN loss of ``trainer.make_train_step``;
  * per-split validation of at most 50 instances, early stopping on the mean
    of the splits' primal-gap medians once every dataset is active;
  * ``best/`` and ``last/`` checkpoints carrying the whole config, ``last/``
    with the optimizer state; an optional warm start from a parameter tree.
Entry point: ``train_progressive(config, specs, init_params=None,
log_fn=print, device=None)``, on the GPU unless ``device="cpu"``.  Each
batch of the curriculum is one call of ``BatchStepper`` (the tracer's span
``lapgnn.train.call``): the fetch (a gather from the device cache, or the
stack and upload; ``lapgnn.train.batch``), the train step and the readback
rule.  Its copies go through ``tracing``, so ``host_syncs`` counts them.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from .checkpoint import merge_params, save_checkpoint
from .schedule import make_optimizer, warmup_cosine
from .trainer import (
    build_one_gnn,
    load_params,
    make_eval_step,
    make_train_step,
    model_params,
    trainable_parameters,
)

__all__ = [
    "BATCH_SIZE_RULES",
    "BatchStepper",
    "DEVICE_CACHE_MIN_N",
    "DatasetSpec",
    "RoundRobinSampler",
    "SYNC_MIN_N",
    "default_batch_size",
    "train_progressive",
]

# Size-dependent batch sizes: (largest n, batch size).
BATCH_SIZE_RULES: List[Tuple[int, int]] = [(1024, 32), (2048, 16), (4096, 8)]

# Datasets at or above this size are kept on the device under
# ``training.device_cache``; below it the upload of each batch is cheap.
DEVICE_CACHE_MIN_N = 2048

# Sizes at or above this read each step's loss back to the host (one
# ``.item()``), which bounds the batches in flight; below it a step queues
# without a synchronisation.
SYNC_MIN_N = DEVICE_CACHE_MIN_N

# Validation instances per split.
VAL_CAP = 50


def default_batch_size(n: int, rules: Optional[Sequence[Tuple[int, int]]] = None) -> int:
    for bound, bs in rules or BATCH_SIZE_RULES:
        if n <= bound:
            return bs
    return 4


@dataclasses.dataclass
class DatasetSpec:
    name: str
    size: int
    instances: Sequence[Dict[str, np.ndarray]]
    weight: float = 1.0
    curriculum_start_epoch: int = 0
    val_instances: Optional[Sequence[Dict[str, np.ndarray]]] = None


class RoundRobinSampler:
    """Yields (spec, instance indices) round-robin over the active datasets."""

    def __init__(
        self,
        specs: Sequence[DatasetSpec],
        batches_per_size: int = 6,
        batch_size_rules: Optional[Sequence[Tuple[int, int]]] = None,
        seed: int = 0,
    ):
        self.specs = list(specs)
        self.batches_per_size = batches_per_size
        self.rules = batch_size_rules
        self.rng = np.random.default_rng(seed)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _batches_for(self, spec: DatasetSpec) -> List[np.ndarray]:
        bs = default_batch_size(spec.size, self.rules)
        order = self.rng.permutation(len(spec.instances))
        if len(order) % bs and len(order) > bs:
            # wrap the tail so every batch of a dataset has one shape
            pad = bs - (len(order) % bs)
            order = np.concatenate([order, order[:pad]])
        return [order[i : i + bs] for i in range(0, len(order), bs)]

    @staticmethod
    def materialize(spec: DatasetSpec, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Stack the selected instances into float32 (cost, u) arrays."""
        insts = [spec.instances[k] for k in idx]
        cost = np.stack([x["cost"] for x in insts]).astype(np.float32)
        u = np.stack([x["u"] for x in insts]).astype(np.float32)
        return cost, u

    def __iter__(self) -> Iterator[Tuple[DatasetSpec, np.ndarray, np.ndarray]]:
        for spec, idx in self.iter_indices():
            cost, u = self.materialize(spec, idx)
            yield spec, cost, u

    def iter_indices(self) -> Iterator[Tuple[DatasetSpec, np.ndarray]]:
        """The epoch's (spec, instance indices) batches."""
        active = [s for s in self.specs if s.curriculum_start_epoch <= self.epoch]
        if not active:
            return
        # keyed by position: two specs may share a name
        queues = {i: self._batches_for(s) for i, s in enumerate(active)}
        # the largest dataset paces the epoch; the others reshuffle on exhaust
        primary = max(queues, key=lambda i: len(queues[i]))
        done = False
        while not done:
            for i, spec in enumerate(active):
                turns = max(1, round(self.batches_per_size * spec.weight))
                for _ in range(turns):
                    if not queues[i]:
                        if i == primary:
                            done = True  # the other specs still take their turns
                            break
                        queues[i] = self._batches_for(spec)
                    yield spec, queues[i].pop()


def _stack_f32(instances, key: str) -> np.ndarray:
    return np.stack([np.asarray(x[key], np.float32) for x in instances])


class BatchStepper:
    """One optimizer step of the curriculum on one batch.

    ``stepper(spec, idx, generator)`` fetches the batch of ``spec``'s
    instances ``idx``, runs ``train_step`` on it and returns its loss: a
    float read back to the host when ``spec.size >= SYNC_MIN_N`` (which
    bounds the batches in flight), else the loss as a device tensor (small
    sizes keep queueing).  Under ``cache_mode`` "bf16" or "f32" the
    instances of every spec of at least ``DEVICE_CACHE_MIN_N`` are uploaded
    once here (``caches``: ``id(spec)`` -> (costs, targets)) and each batch
    is gathered on the device; bf16 halves the bytes, its costs rounded to
    bf16 and upcast to float32 for the step (a training-time perturbation
    only: the targets stay float32).  Other specs stack each batch on the
    host and upload it."""

    def __init__(self, train_step, device, specs: Sequence[DatasetSpec] = (),
                 cache_mode: str = "off"):
        self.train_step = train_step
        self.device = torch.device(device)
        self.caches: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        if cache_mode not in ("off", "bf16", "f32"):
            raise ValueError(f"training.device_cache must be off|bf16|f32, got {cache_mode!r}")
        if cache_mode == "off":
            return
        cdt = torch.bfloat16 if cache_mode == "bf16" else torch.float32
        for s in specs:
            if s.size >= DEVICE_CACHE_MIN_N:
                cost = torch.from_numpy(_stack_f32(s.instances, "cost"))
                u = torch.from_numpy(_stack_f32(s.instances, "u"))
                self.caches[id(s)] = (tracing.to_device(cost, self.device).to(cdt),
                                      tracing.to_device(u, self.device))

    @tracing.spanned("train.call", lambda self, *args, **kwargs: self.device)
    def __call__(self, spec: DatasetSpec, idx: np.ndarray, generator=None):
        with tracing.span("train.batch", self.device):
            if id(spec) in self.caches:
                costs, targets = self.caches[id(spec)]
                ib = tracing.to_device(torch.from_numpy(np.asarray(idx, np.int64)), self.device)
                cost_d = costs.index_select(0, ib).to(torch.float32)
                u_d = targets.index_select(0, ib)
            else:
                cost, u = RoundRobinSampler.materialize(spec, idx)
                cost_d = tracing.to_device(torch.from_numpy(cost), self.device)
                u_d = tracing.to_device(torch.from_numpy(u), self.device)
        loss = self.train_step(cost_d, u_d, generator)["loss"]
        return tracing.item(loss) if spec.size >= SYNC_MIN_N else loss


def train_progressive(
    config: Dict,
    specs: Sequence[DatasetSpec],
    init_params=None,
    log_fn=print,
    device=None,
):
    """Run the curriculum.  ``config`` has the JAX trainer's shape: model /
    loss / optimizer / sampling / training / checkpointing keys.  Returns
    (best params as a flax tree, history)."""
    mcfg = config.get("model", {})
    ocfg = config.get("optimizer", {})
    scfg = config.get("sampling", {})
    tcfg = config.get("training", {})
    ccfg = config.get("checkpointing", {})
    lcfg = config.get("loss", {})

    if not specs:
        raise ValueError(
            "no datasets with instances — check the config's sizes/paths "
            "(every dataset was skipped at load time)"
        )
    dev = resolve_device(device)
    seed = int(tcfg.get("seed", 0))
    hidden = int(mcfg.get("hidden", 64))
    layers = int(mcfg.get("layers", 2))
    dropout = float(mcfg.get("dropout", 0.1))
    topk = int(mcfg.get("topk", 16))
    context = bool(mcfg.get("context", False))
    model = build_one_gnn(hidden, layers, dropout, topk, context, seed, dev)
    use_cost = bool(mcfg.get("use_cost_refinement", False))
    normalize_gap = bool(lcfg.get("normalize_gap", False))
    include_primal = bool(lcfg.get("include_primal", True))
    normalize_costs = bool(lcfg.get("normalize_costs", False))

    epochs = int(tcfg.get("epochs", 40))
    min_epochs = int(tcfg.get("min_epochs", 10))
    patience = int(tcfg.get("patience", 6))
    cache_mode = str(tcfg.get("device_cache", "off")).lower()

    sampler = RoundRobinSampler(
        specs, batches_per_size=int(scfg.get("batches_per_size", 6)), seed=seed
    )

    # Rough steps per epoch for the schedule, as the JAX trainer counts them.
    steps_per_epoch = sum(-(-len(s.instances) // default_batch_size(s.size)) for s in specs)
    total_steps = max(1, steps_per_epoch * epochs)
    schedule = warmup_cosine(
        float(ocfg.get("lr", 1e-3)),
        int(float(ocfg.get("warmup_frac", 0.1)) * total_steps),
        total_steps,
        float(ocfg.get("min_lr", 0.0)),
    )

    if init_params is not None:
        merged, n_loaded, n_total = merge_params(model_params(model, use_cost), init_params)
        load_params(model, merged)
        log_fn(f"warm init: {n_loaded}/{n_total} leaves restored")
    optimizer = make_optimizer(
        trainable_parameters(model, use_cost),
        schedule,
        float(ocfg.get("weight_decay", 1e-4)),
        float(ocfg.get("grad_clip", 1.0)),
    )
    train_step = make_train_step(
        model, optimizer, use_cost, normalize_gap, include_primal, normalize_costs
    )
    # Validation gaps are not normalised, whatever the training loss does.
    eval_step = make_eval_step(model, use_cost, normalize_costs=normalize_costs)
    dropout_gen = torch.Generator(device=dev).manual_seed(seed)

    # Device-resident datasets (training.device_cache: bf16 | f32): the
    # stepper uploads each training instance once; validation stays float32.
    stepper = BatchStepper(train_step, dev, specs, cache_mode)
    val_caches: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    for s in specs:
        if id(s) not in stepper.caches:
            continue
        if s.val_instances:
            vals = list(s.val_instances)[:VAL_CAP]
            val_caches[id(s)] = (
                tracing.to_device(torch.from_numpy(_stack_f32(vals, "cost")), dev),
                tracing.to_device(torch.from_numpy(_stack_f32(vals, "u")), dev),
            )
        train_shape = tuple(stepper.caches[id(s)][0].shape)
        log_fn(
            f"device-cached {s.name}: train {train_shape} as {cache_mode}"
            + (", val f32" if id(s) in val_caches else "")
        )

    out_dir = Path(ccfg.get("output_dir", "artifacts/progressive"))
    meta_base = {
        "architecture": "one_gnn",
        "hidden": hidden,
        "layers": layers,
        "dropout": dropout,
        "topk": topk,
        "context": context,
        "use_cost_refinement": use_cost,
        "row_feat_dim": 21,
        "config": config,
    }

    history = {"train_loss": [], "val_gap_median_avg": []}
    best = {"gap": float("inf"), "params": model_params(model, use_cost)}
    bad = 0
    # Best and early stopping only compare epochs that validate the same
    # splits: once every dataset is active.
    all_active_epoch = max((s.curriculum_start_epoch for s in specs), default=0)

    for epoch in range(epochs):
        t0 = time.perf_counter()
        sampler.set_epoch(epoch)
        losses = []
        for spec, idx in sampler.iter_indices():
            losses.append(stepper(spec, idx, dropout_gen))
        losses = [tracing.item(l) if isinstance(l, torch.Tensor) else l for l in losses]
        history["train_loss"].append(float(np.mean(losses)) if losses else 0.0)

        split_medians = []
        for spec in specs:
            vals = spec.val_instances or []
            if not vals or spec.curriculum_start_epoch > epoch:
                continue
            gaps = []
            bs = default_batch_size(spec.size)
            for s in range(0, min(len(vals), VAL_CAP), bs):
                e = min(s + bs, VAL_CAP)
                if id(spec) in val_caches:
                    Vc, Vu = val_caches[id(spec)]
                    cost_d, u_d = Vc[s:e], Vu[s:e]
                else:
                    chunk = vals[s:e]
                    cost_d = tracing.to_device(torch.from_numpy(_stack_f32(chunk, "cost")), dev)
                    u_d = tracing.to_device(torch.from_numpy(_stack_f32(chunk, "u")), dev)
                gaps.extend(tracing.to_host(eval_step(cost_d, u_d)["primal_gap"]).tolist())
            if gaps:
                split_medians.append(float(np.median(gaps)))

        gap_avg = float(np.mean(split_medians)) if split_medians else float("inf")
        history["val_gap_median_avg"].append(gap_avg)
        if not split_medians:
            # no validation: keep the latest params and never stop early
            best = {"gap": float("inf"), "params": model_params(model, use_cost)}
            bad = 0
        log_fn(
            f"epoch {epoch}: loss={history['train_loss'][-1]:.4f} "
            f"val_gap_med_avg={gap_avg:.4f} ({time.perf_counter() - t0:.1f}s)"
        )

        save_checkpoint(
            out_dir / "last",
            model_params(model, use_cost),
            {**meta_base, "epoch": epoch, "val_gap_median_avg": gap_avg},
            opt_state=optimizer.state_dict(),
        )
        if epoch < all_active_epoch:
            continue
        if gap_avg < best["gap"] - 1e-9:
            best = {"gap": gap_avg, "params": model_params(model, use_cost)}
            bad = 0
            save_checkpoint(
                out_dir / "best",
                best["params"],
                {**meta_base, "epoch": epoch, "val_gap_median_avg": gap_avg},
            )
        elif epoch + 1 >= min_epochs:
            bad += 1
            if bad >= patience:
                log_fn(f"early stop at epoch {epoch}")
                break

    return best["params"], history
