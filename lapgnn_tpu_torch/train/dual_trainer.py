"""DualGNN training loop.

Port of ``lapgnn_tpu/train/dual_trainer.py`` (``DualTrainConfig`` :32,
``make_dual_train_step`` :58, ``make_dual_eval_step`` :98,
``train_dual_gnn`` :116).  As the OneGNN trainer (``train/trainer.py``), the
step is eager PyTorch whose one hand-written kernel is the loss's greedy
bound (``ops.cuda.greedy_total``), and it reads nothing back to the host.
The dense graph features (14 a node, 10 an edge) are computed on the device
inside the step, without gradient, since none flows into the cost.  Memory
is O(B·n²·hidden): autograd keeps each layer's edge activations.

Parameters start from flax's initialisers (``build_dual_gnn``) drawn from a
``torch.Generator`` seeded with the config's seed; batches shuffle with
numpy's ``default_rng(seed)`` in JAX's sequence (``BucketBatcher``).  The
model draws one integer seed a layer for its dropout masks from the
caller's generator, so the trainer hands it a CPU generator: the seeds need
no read from the card.  The global torch RNG is never touched.

``mesh=`` (a ('row', 'col') mesh from ``parallel.dual.dual_mesh``) trains
with the 2-D edge-partitioned steps of ``parallel.dual``: every rank runs
this function, takes its tile of each batch and its rows' target duals,
and ends with the same parameters and history as the others; only rank 0
logs.  Under a mesh the loss is the dual surrogate (no greedy bound), as in
JAX, so its losses and gaps compare within a run, not with an unsharded one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed

from .. import tracing
from ..device import resolve_device
from ..models import DualGNN
from ..models.dual_gnn import DualLayer, attention_init_
from ..ops.features import graph_features
from .checkpoint import merge_params
from .convert import params_from_flax, params_to_flax
from .loss import dual_gnn_loss
from .schedule import AdamW, make_optimizer, warmup_cosine
from .trainer import BucketBatcher, _lecun_normal_

__all__ = [
    "DualTrainConfig",
    "build_dual_gnn",
    "dual_loss_and_grads",
    "make_dual_eval_step",
    "make_dual_train_step",
    "train_dual_gnn",
]


@dataclasses.dataclass
class DualTrainConfig:
    hidden: int = 128
    layers: int = 4
    heads: int = 4
    dropout: float = 0.1
    lr: float = 1e-3
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    warmup_frac: float = 0.1
    epochs: int = 10
    batch_size: int = 8
    min_epochs: int = 5
    patience: int = 6
    seed: int = 0
    # the sentinel-clipped, size-normalised loss with oracle-dual supervision
    # (train/loss.dual_gnn_loss): the JAX trainer's defaults
    clip_sentinels: bool = True
    normalize_gap: bool = True
    supervise_duals: bool = True


def build_dual_gnn(
    hidden: int = 128,
    layers: int = 4,
    heads: int = 4,
    dropout: float = 0.1,
    seed: int = 0,
    device=None,
) -> DualGNN:
    """A ``DualGNN`` with flax's initial values drawn from a CPU generator
    seeded with ``seed``, then moved to ``device``: LeCun-normal Dense
    kernels and zero biases, unit LayerNorm scales, the attention weights
    uniform with flax's fans (``attention_init_``) and zero attention
    biases.  Built on the meta device first, so that nothing is drawn from
    the global RNG."""
    with torch.device("meta"):
        model = DualGNN(hidden_dim=hidden, layers=layers, heads=heads, dropout=dropout)
    model = model.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.Linear):
                _lecun_normal_(module.weight, gen)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, torch.nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, DualLayer):
                attention_init_(module.attn_row, gen)
                attention_init_(module.attn_col, gen)
                module.attn_row_bias.zero_()
                module.attn_col_bias.zero_()
    return model.to(resolve_device(device))


def _forward_loss(model, cost, u_target, clip_sentinels, normalize_gap, generator):
    dev = cost.device
    with tracing.span("train.features", dev), torch.no_grad():
        gf = graph_features(cost)
    with tracing.span("train.forward", dev):
        preds = model(gf.edge_feat, gf.row_feat, gf.col_feat, generator=generator)
    with tracing.span("train.loss", dev):
        return dual_gnn_loss(
            cost, preds, normalize_gap=normalize_gap, clip_sentinels=clip_sentinels,
            u_target=u_target,
        )


def dual_loss_and_grads(
    model: DualGNN,
    params: Sequence[torch.Tensor],
    cost: torch.Tensor,
    u_target: Optional[torch.Tensor],
    clip_sentinels: bool = True,
    normalize_gap: bool = True,
    generator: Optional[torch.Generator] = None,
):
    """(loss, metrics, grads) of one batch; ``u_target=None`` leaves the
    oracle-dual term out.  A parameter the loss does not reach gets zeros,
    as from ``jax.grad``."""
    loss, metrics = _forward_loss(model, cost, u_target, clip_sentinels, normalize_gap, generator)
    with tracing.span("train.backward", cost.device):
        grads = torch.autograd.grad(loss, list(params), allow_unused=True, materialize_grads=True)
    return loss, metrics, grads


def make_dual_train_step(
    model: DualGNN,
    optimizer: AdamW,
    clip_sentinels: bool = True,
    normalize_gap: bool = True,
    supervise_duals: bool = True,
):
    """``step(cost, u_target, generator=None) -> metrics``: one optimizer
    update of ``optimizer.params`` in place; the metrics stay on the
    device.  A step is the tracer's root span ``lapgnn.train.step``, with
    ``train.features``, ``.forward``, ``.loss``, ``.backward`` and
    ``.optimizer`` inside."""

    @tracing.spanned("train.step", lambda cost, *args, **kwargs: cost.device)
    def step(cost: torch.Tensor, u_target: torch.Tensor, generator=None) -> Dict[str, torch.Tensor]:
        loss, metrics, grads = dual_loss_and_grads(
            model, optimizer.params, cost, u_target if supervise_duals else None,
            clip_sentinels, normalize_gap, generator,
        )
        with tracing.span("train.optimizer", cost.device):
            optimizer.step(grads)
        return {
            "loss": loss.detach(),
            "primal_gap_mean": metrics["primal_gap"].detach().mean(),
            "feas_mean": metrics["feas"].detach().mean(),
            "v_mse_mean": metrics["v_mse"].detach().mean(),
        }

    return step


def make_dual_eval_step(model: DualGNN, clip_sentinels: bool = True, normalize_gap: bool = True):
    """``step(cost) -> {primal_gap, feas}`` per instance, without dropout,
    supervision or gradients."""

    @torch.no_grad()
    def step(cost: torch.Tensor) -> Dict[str, torch.Tensor]:
        _, metrics = _forward_loss(model, cost, None, clip_sentinels, normalize_gap, None)
        return {"primal_gap": metrics["primal_gap"], "feas": metrics["feas"]}

    return step


def _silent(_msg: str) -> None:
    pass


def train_dual_gnn(
    train_instances: Sequence[Dict[str, np.ndarray]],
    val_instances: Optional[Sequence[Dict[str, np.ndarray]]] = None,
    config: Optional[DualTrainConfig] = None,
    log_fn: Callable[[str], None] = print,
    mesh=None,
    init_params: Optional[dict] = None,
    device=None,
) -> Tuple[dict, Dict[str, list]]:
    """Train (or, with ``init_params``, a flax tree, fine-tune) a DualGNN.
    Returns (best params as a flax tree, history), with early stopping on
    the validation primal-gap median, as the JAX trainer.  With ``mesh``
    the model lives on ``mesh.device`` (``device`` is not read)."""
    cfg = config or DualTrainConfig()
    if mesh is not None:
        from ..parallel.dual import require_dual_mesh

        require_dual_mesh(mesh)
        if torch.distributed.get_rank() != 0:
            log_fn = _silent
    dev = resolve_device(device) if mesh is None else mesh.device
    model = build_dual_gnn(cfg.hidden, cfg.layers, cfg.heads, cfg.dropout, cfg.seed, dev)

    batcher = BucketBatcher(train_instances, cfg.batch_size, seed=cfg.seed)
    total_steps = max(1, batcher.num_batches()) * cfg.epochs
    schedule = warmup_cosine(cfg.lr, int(cfg.warmup_frac * total_steps), total_steps)

    if init_params is not None:
        merged, n_loaded, n_total = merge_params(params_to_flax(model.state_dict()), init_params)
        model.load_state_dict(params_from_flax(merged))
        log_fn(f"warm init: {n_loaded}/{n_total} param leaves from checkpoint")
    optimizer = make_optimizer(list(model.parameters()), schedule, cfg.weight_decay, cfg.grad_clip)
    if mesh is None:
        train_step = make_dual_train_step(
            model, optimizer, cfg.clip_sentinels, cfg.normalize_gap, cfg.supervise_duals
        )
        eval_step = make_dual_eval_step(model, cfg.clip_sentinels, cfg.normalize_gap)

        def batch(cost, u):
            return torch.from_numpy(cost).to(dev), torch.from_numpy(u).to(dev)
    else:
        from ..parallel.dual import (
            local_tile,
            make_sharded_dual_eval_step,
            make_sharded_dual_train_step,
        )

        train_step = make_sharded_dual_train_step(
            model, optimizer, mesh, cfg.clip_sentinels, cfg.normalize_gap, cfg.supervise_duals
        )
        eval_step = make_sharded_dual_eval_step(model, mesh, cfg.clip_sentinels, cfg.normalize_gap)

        def batch(cost, u):
            rows = u.shape[-1] // mesh.size("row")
            first = mesh.coordinate("row") * rows
            return (local_tile(torch.from_numpy(cost), mesh).to(dev),
                    torch.from_numpy(u[:, first:first + rows]).to(dev))
    dropout_gen = torch.Generator().manual_seed(int(cfg.seed))

    history: Dict[str, list] = {"train_loss": [], "val_gap_median": []}
    best_params = params_to_flax(model.state_dict())
    best_gap = float("inf")
    bad = 0

    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        losses = []
        for cost, u, _ in batcher:
            m = train_step(*batch(cost, u), dropout_gen)
            losses.append(m["loss"])  # a device tensor: no sync a step
        history["train_loss"].append(
            float(np.mean(torch.stack(losses).tolist())) if losses else 0.0
        )

        if val_instances:
            gaps = []
            for cost, u, _ in BucketBatcher(val_instances, cfg.batch_size, seed=0):
                gaps.extend(eval_step(batch(cost, u)[0])["primal_gap"].tolist())
            gap_med = float(np.median(gaps)) if gaps else float("inf")
            history["val_gap_median"].append(gap_med)
            log_fn(
                f"epoch {epoch}: loss={history['train_loss'][-1]:.4f} "
                f"val_gap_med={gap_med:.4f} ({time.perf_counter() - t0:.1f}s)"
            )
            if gap_med < best_gap - 1e-9:
                best_gap, best_params, bad = gap_med, params_to_flax(model.state_dict()), 0
            elif epoch + 1 >= cfg.min_epochs:
                bad += 1
                if bad >= cfg.patience:
                    log_fn(f"early stop at epoch {epoch}")
                    break
        else:
            best_params = params_to_flax(model.state_dict())
            log_fn(f"epoch {epoch}: loss={history['train_loss'][-1]:.4f}")

    return best_params, history
