"""OneGNN training loop over size-bucketed batches.

Port of ``lapgnn_tpu/train/trainer.py`` (``TrainConfig`` :33,
``BucketBatcher`` :71, ``_normalize_instance`` :111, ``make_train_step``
:130, ``make_eval_step`` :174, ``train_one_gnn`` :198).  The JAX train step
is one jitted program; here it is eager PyTorch whose only hand-written
kernel is the loss's greedy bound (``ops.cuda.greedy_total``), and it reads
nothing back to the host, so steps queue on the device.  The 21-D features
come from the sort-based ``row_features``, as in the JAX step.

The state is the ``nn.Module`` and the optimizer (``schedule.AdamW``,
optax's arithmetic).  Parameters start from flax's initialisers (LeCun
normal kernels, zero biases, unit LayerNorm scales) drawn from a
``torch.Generator`` seeded with the config's seed, and dropout draws from a
second one: the global torch RNG is never touched, and two runs with one
seed on the CPU end with bit-equal parameters.  Batches shuffle with numpy's
``default_rng(seed)``, in the same sequence as JAX's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from ..models import OneGNN
from ..ops.dual import robust_normalize
from ..ops.features import row_features
from .convert import params_from_flax, params_to_flax
from .loss import one_gnn_loss
from .schedule import AdamW, make_optimizer, warmup_cosine

__all__ = [
    "BucketBatcher",
    "State",
    "TrainConfig",
    "build_one_gnn",
    "load_params",
    "loss_and_grads",
    "make_eval_step",
    "make_train_step",
    "model_params",
    "train_one_gnn",
    "trainable_parameters",
]

# Modules flax creates only when the model is initialised with a cost.
_REFINE_PREFIXES = ("edge_mlp.", "message_norm.")


@dataclasses.dataclass
class TrainConfig:
    hidden: int = 64
    layers: int = 2
    dropout: float = 0.1
    topk: int = 16
    context: bool = False
    use_cost_refinement: bool = False
    normalize_gap: bool = False  # scale-free primal gap across sizes
    normalize_costs: bool = False  # train in the space the pipeline serves in
    include_primal: bool = True  # greedy upper bound term (False: dual surrogate)
    lr: float = 1e-3
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    warmup_frac: float = 0.1
    min_lr: float = 0.0
    epochs: int = 10
    batch_size: int = 32
    min_epochs: int = 10
    patience: int = 6
    seed: int = 0


@dataclasses.dataclass
class State:
    """The JAX trainer's ``State(params, opt_state, step)`` over the port's
    optimizer: ``optimizer.params`` are the parameters (the model's own
    tensors, updated in place), its moments the optimizer state and its
    count of updates the step."""

    optimizer: AdamW

    @property
    def params(self) -> List[torch.Tensor]:
        return self.optimizer.params

    @property
    def step(self) -> int:
        return self.optimizer.count


class BucketBatcher:
    """Groups instances by size and yields shuffled same-size batches of
    float32 (cost, u, v) numpy arrays."""

    def __init__(
        self,
        instances: Sequence[Dict[str, np.ndarray]],
        batch_size: int,
        seed: int = 0,
    ):
        self.by_size: Dict[int, List[Dict[str, np.ndarray]]] = {}
        for inst in instances:
            self.by_size.setdefault(int(inst["n"]), []).append(inst)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        jobs = []
        for n, insts in self.by_size.items():
            order = self.rng.permutation(len(insts))
            for s in range(0, len(insts), self.batch_size):
                jobs.append((n, order[s : s + self.batch_size]))
        self.rng.shuffle(jobs)
        for n, idx in jobs:
            insts = self.by_size[n]
            cost = np.stack([insts[i]["cost"] for i in idx]).astype(np.float32)
            u = np.stack([insts[i]["u"] for i in idx]).astype(np.float32)
            v = np.stack([insts[i]["v"] for i in idx]).astype(np.float32)
            yield cost, u, v

    def num_batches(self) -> int:
        return sum(-(-len(v) // self.batch_size) for v in self.by_size.values())


def _normalize_instance(cost: torch.Tensor, u_target: torch.Tensor):
    """Per-instance affine rescale with the serving pipeline's
    sentinel-robust ``robust_normalize``; under C' = (C - mn) / a the optimal
    row duals map as u' = (u - mn) / a."""
    cost_n, mn, a = robust_normalize(cost)
    u_n = (u_target - mn[..., None]) / a[..., None]
    return cost_n, u_n


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default Dense kernel: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = (1.0 / weight.shape[1]) ** 0.5 / 0.87962566103423978
    torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def build_one_gnn(
    hidden: int = 64,
    layers: int = 2,
    dropout: float = 0.1,
    topk: int = 16,
    context: bool = False,
    seed: int = 0,
    device=None,
) -> OneGNN:
    """A ``OneGNN`` with flax's initial values drawn from a CPU generator
    seeded with ``seed`` (the same values on every device), then moved to
    ``device``.  The module is built on the meta device first, so PyTorch's
    own initialisers draw nothing from the global RNG."""
    with torch.device("meta"):
        model = OneGNN(hidden=hidden, layers=layers, dropout=dropout, topk=topk, context=context)
    model = model.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.Linear):
                _lecun_normal_(module.weight, gen)
                module.bias.zero_()
            elif isinstance(module, torch.nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
    return model.to(resolve_device(device))


def trainable_parameters(model: OneGNN, refine: bool) -> List[torch.Tensor]:
    """The parameters the JAX tree holds: all of them with the top-k
    refinement, all but its modules without (flax never creates those)."""
    return [
        p for name, p in model.named_parameters()
        if refine or not name.startswith(_REFINE_PREFIXES)
    ]


def model_params(model: OneGNN, refine: bool) -> dict:
    """The model's parameters as the flax tree the JAX trainer holds."""
    return params_to_flax(model.state_dict(), refine=refine)


def load_params(model: OneGNN, tree) -> None:
    """Load a flax tree into ``model`` in place; a tree without the
    refinement's leaves leaves those modules as they are."""
    missing, unexpected = model.load_state_dict(params_from_flax(tree), strict=False)
    if unexpected or any(not k.startswith(_REFINE_PREFIXES) for k in missing):
        raise ValueError(f"parameter tree does not fit the model: missing {missing}, unexpected {unexpected}")


def _forward_loss(
    model, cost, u_target, use_cost, normalize_gap, include_primal, normalize_costs, generator
):
    dev = cost.device
    if normalize_costs:
        with tracing.span("train.normalize", dev):
            cost, u_target = _normalize_instance(cost, u_target)
    with tracing.span("train.features", dev), torch.no_grad():
        feats = row_features(cost)
    with tracing.span("train.forward", dev):
        preds = model(feats, cost=cost if use_cost else None, generator=generator)
    with tracing.span("train.loss", dev):
        return one_gnn_loss(
            cost, u_target, preds, normalize_gap=normalize_gap, include_primal=include_primal
        )


def loss_and_grads(
    model: OneGNN,
    params: Sequence[torch.Tensor],
    cost: torch.Tensor,
    u_target: torch.Tensor,
    use_cost: bool,
    normalize_gap: bool = False,
    include_primal: bool = True,
    normalize_costs: bool = False,
    generator: Optional[torch.Generator] = None,
):
    """(loss, metrics, grads): the loss of one batch and its gradient with
    respect to ``params``, zeros for a parameter the loss does not reach (as
    ``jax.grad`` gives)."""
    loss, metrics = _forward_loss(
        model, cost, u_target, use_cost, normalize_gap, include_primal, normalize_costs, generator
    )
    with tracing.span("train.backward", cost.device):
        grads = torch.autograd.grad(loss, list(params), allow_unused=True, materialize_grads=True)
    return loss, metrics, grads


def make_train_step(
    model: OneGNN,
    optimizer: AdamW,
    use_cost: bool,
    normalize_gap: bool = False,
    include_primal: bool = True,
    normalize_costs: bool = False,
):
    """``step(cost, u_target, generator) -> metrics``: one optimizer update
    of ``optimizer.params`` in place.  The metrics stay on the device.  A
    step is the tracer's root span ``lapgnn.train.step``, with
    ``train.normalize`` (under ``normalize_costs``), ``.features``,
    ``.forward``, ``.loss``, ``.backward`` and ``.optimizer`` inside."""

    @tracing.spanned("train.step", lambda cost, *args, **kwargs: cost.device)
    def step(cost: torch.Tensor, u_target: torch.Tensor, generator=None) -> Dict[str, torch.Tensor]:
        loss, metrics, grads = loss_and_grads(
            model, optimizer.params, cost, u_target, use_cost,
            normalize_gap, include_primal, normalize_costs, generator,
        )
        with tracing.span("train.optimizer", cost.device):
            optimizer.step(grads)
        return {
            "loss": loss.detach(),
            "primal_gap_mean": metrics["primal_gap"].detach().mean(),
            "feas_mean": metrics["feas"].detach().mean(),
            "u_mse_mean": metrics["u_mse"].detach().mean(),
        }

    return step


def make_eval_step(
    model: OneGNN,
    use_cost: bool,
    normalize_gap: bool = False,
    normalize_costs: bool = False,
):
    """``step(cost, u_target) -> {primal_gap, feas, u_mse}`` per instance,
    without dropout or gradients."""

    @torch.no_grad()
    def step(cost: torch.Tensor, u_target: torch.Tensor) -> Dict[str, torch.Tensor]:
        _, metrics = _forward_loss(
            model, cost, u_target, use_cost, normalize_gap, True, normalize_costs, None
        )
        return {"primal_gap": metrics["primal_gap"], "feas": metrics["feas"], "u_mse": metrics["u_mse"]}

    return step


def train_one_gnn(
    train_instances: Sequence[Dict[str, np.ndarray]],
    val_instances: Optional[Sequence[Dict[str, np.ndarray]]] = None,
    config: Optional[TrainConfig] = None,
    log_fn: Callable[[str], None] = print,
    device=None,
) -> Tuple[dict, Dict[str, list]]:
    """Train OneGNN; returns (best params as a flax tree, history).  Early
    stopping on the validation primal-gap median with patience."""
    cfg = config or TrainConfig()
    dev = resolve_device(device)
    model = build_one_gnn(cfg.hidden, cfg.layers, cfg.dropout, cfg.topk, cfg.context, cfg.seed, dev)
    refine = cfg.use_cost_refinement

    batcher = BucketBatcher(train_instances, cfg.batch_size, seed=cfg.seed)
    steps_per_epoch = max(1, batcher.num_batches())
    total_steps = steps_per_epoch * cfg.epochs
    schedule = warmup_cosine(cfg.lr, int(cfg.warmup_frac * total_steps), total_steps, cfg.min_lr)
    optimizer = make_optimizer(
        trainable_parameters(model, refine), schedule, cfg.weight_decay, cfg.grad_clip
    )
    train_step = make_train_step(
        model, optimizer, refine, cfg.normalize_gap, cfg.include_primal, cfg.normalize_costs
    )
    eval_step = make_eval_step(model, refine, normalize_costs=cfg.normalize_costs)
    dropout_gen = torch.Generator(device=dev).manual_seed(int(cfg.seed))

    history: Dict[str, list] = {"train_loss": [], "val_gap_median": []}
    best_params = model_params(model, refine)
    best_gap = float("inf")
    bad_epochs = 0

    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        losses = []
        for cost, u, _ in batcher:
            m = train_step(torch.from_numpy(cost).to(dev), torch.from_numpy(u).to(dev), dropout_gen)
            losses.append(m["loss"])  # a device tensor: no sync a step
        history["train_loss"].append(
            float(np.mean(torch.stack(losses).tolist())) if losses else 0.0
        )

        if val_instances:
            gaps = []
            for cost, u, _ in BucketBatcher(val_instances, cfg.batch_size, seed=0):
                m = eval_step(torch.from_numpy(cost).to(dev), torch.from_numpy(u).to(dev))
                gaps.extend(m["primal_gap"].tolist())
            gap_med = float(np.median(gaps)) if gaps else float("inf")
            history["val_gap_median"].append(gap_med)
            log_fn(
                f"epoch {epoch}: loss={history['train_loss'][-1]:.4f} "
                f"val_gap_med={gap_med:.4f} ({time.perf_counter() - t0:.1f}s)"
            )
            if gap_med < best_gap - 1e-9:
                best_gap = gap_med
                best_params = model_params(model, refine)
                bad_epochs = 0
            elif epoch + 1 >= cfg.min_epochs:
                bad_epochs += 1
                if bad_epochs >= cfg.patience:
                    log_fn(f"early stop at epoch {epoch}")
                    break
        else:
            best_params = model_params(model, refine)
            log_fn(
                f"epoch {epoch}: loss={history['train_loss'][-1]:.4f} "
                f"({time.perf_counter() - t0:.1f}s)"
            )

    return best_params, history
