"""Closed-loop steps of OneGNN's progressive training at one stage of its
curriculum: each step is one call of ``train.progressive.BatchStepper``, the
seam ``train_progressive`` runs every batch through (the batch gathered from
the device cache, ``make_train_step``'s step, the loss read back at n >=
``SYNC_MIN_N``), on the pool's batches in a seeded order.  The rate counts
every sample of the steps the window ran, over the window up to the
device's end of its last step.

Set-up builds the one training object as ``train_progressive`` builds it
(the model warm-started from the checkpoint, AdamW at a constant rate, the
step, the stepper with the pool cached on the device), makes the pool's
target duals itself (the reference's float64 optimum and duals, not the
program's), and drives the stepper through its first steps with dropout
drawn from a seeded generator on the device.  The first three are held to
the reference (``lapbench/reference/one_gnn.py``): the first step's outputs
of each instance (u_pre, the pre-output that the top-k refinement reads, and
u side by side), the first step's loss (the greedy bound's primal gap is
nearly all of it), the first gradient's median leaf, and the whole norm of
the parameters' change after the first step and after the third.  What
rounding alone sets is not held: the reference runs a second time from
weights moved by ``ROUNDING``, and an instance, the loss, the first gradient
or a leaf of a change that this moves by more than ``CONDITIONED`` is left
out.  The leaves it leaves out of the change are those whose gradient is
rounding noise (the saturated head's output layer, whose inputs are float32
erf tails): Adam's normalisation turns that noise into steps of up to the
learning rate either way.  From the second step the body's gradients flow
through those steps; where that leaves fewer than half of the leaves held
after three steps (small instances), the change after three steps is
rounding's and only the first step's is compared.

Variants, for the control and the fault tests (never in a benchmark run):
``control`` puts the reference computed in TF32 in the program's place
(the precision below the configuration's float32 with TF32 off);
``half_batch`` feeds the checked steps the first half of each batch;
``unchanged`` skips the optimizer's update in the checked steps;
``greedy_order`` has the greedy bound visit the rows in index order, not by
their least reduced cost, in the checked steps (a wrong bound moves the loss
alone: it carries no gradient).
"""

from __future__ import annotations

import json
import time
from typing import List

import numpy as np
import torch

from lapbench import families, serving, yardstick
from lapbench.reference import lap
from lapbench.reference.dual_gnn import greedy_upper, read_msgpack_params
from lapbench.reference.one_gnn import Reference

CHECKED_STEPS = 3
ROUNDING = 2.0**-22  # the relative move of the reference's weights that reads rounding's reach
CONDITIONED = 1e-4  # the most that the move may shift a number that is held to the reference

# the port's module names -> flax's (``train.convert``)
_FLAX_MODULES = {"input_proj.0": "input_proj", "input_proj.2": "input_norm",
                 "row_out.0": "head_fc1", "row_out.3": "head_fc2",
                 "edge_mlp.0": "edge_fc1", "edge_mlp.2": "edge_fc2"}


class State:
    pass


def _flax_name(torch_name: str) -> str:
    """``blocks.0.fc1.weight`` -> ``block_0/fc1/kernel``; a LayerNorm's
    weight is its ``scale``."""
    module, leaf = torch_name.rsplit(".", 1)
    norm = module in ("input_proj.2", "message_norm") or module.endswith(".norm")
    module = _FLAX_MODULES.get(module, module)
    if module.startswith("blocks."):
        _, i, rest = module.split(".", 2)
        module = f"block_{i}/{rest}"
    if leaf == "weight":
        leaf = "scale" if norm else "kernel"
    return f"{module}/{leaf}"


def _capture(model, outputs: List[torch.Tensor]):
    """Forward hooks that keep each forward's outputs u_pre (``pre_out``,
    the value the refinement reads) and u side by side; returns their
    handles."""
    pre: List[torch.Tensor] = []

    def keep_pre(module, args, out):
        pre.append(out[..., 0].detach().clone())

    def keep(module, args, out):
        outputs.append(torch.cat([pre.pop(), out["u"].detach()], -1))

    return [model.pre_out.register_forward_hook(keep_pre), model.register_forward_hook(keep)]


def _batches(st, count: int, offset: int = 0) -> List[np.ndarray]:
    B, order = st.batch, st.order
    return [np.array([order[(offset + s * B + j) % len(order)] for j in range(B)], np.int64)
            for s in range(count)]


def setup(ctx) -> State:
    from lapgnn_tpu_torch.train.checkpoint import load_checkpoint
    from lapgnn_tpu_torch.train.progressive import BatchStepper, DatasetSpec
    from lapgnn_tpu_torch.train.schedule import make_optimizer
    from lapgnn_tpu_torch.train.trainer import (build_one_gnn, load_params, make_train_step,
                                                trainable_parameters)

    cfg, tr = ctx.config, ctx.traffic
    t0 = time.perf_counter()
    st = State()
    st.n, st.batch = int(tr["n"]), int(tr["batch"])
    names = [tr["families"][i % len(tr["families"])] for i in range(int(tr["pool"]))]
    pool = families.draw(names, st.n, ctx.seed, np.float32)
    st.pool_np = [C for _, C in pool]
    st.order = np.random.default_rng([ctx.seed, 1 << 20]).permutation(len(pool))
    # the targets: optimal duals of each instance, made here
    optima = lap.optima(st.pool_np)
    st.u_np = list(lap.optimal_duals(np.stack(st.pool_np), np.stack([x for _, x in optima]),
                                     ctx.device).astype(np.float32))
    st.spec = DatasetSpec(f"{names[0]}_{st.n}", st.n,
                          [{"cost": C, "u": u} for C, u in zip(st.pool_np, st.u_np)])
    st.dropout_seed = int(np.random.default_rng([ctx.seed, 7]).integers(0, 2**62))
    t_targets = time.perf_counter() - t0

    params, _, _ = load_checkpoint(ctx.root / cfg["checkpoint"])
    refine = bool(cfg["use_cost_refinement"])
    model = build_one_gnn(cfg["hidden"], cfg["layers"], cfg["dropout"], cfg["topk"], False, 0,
                          ctx.device)
    load_params(model, params)
    opt = make_optimizer(trainable_parameters(model, refine), float(cfg["lr"]),
                         cfg["weight_decay"], cfg["grad_clip"])
    st.model, st.opt = model, opt
    st.names = [_flax_name(name) for name, p in model.named_parameters()
                if any(p is q for q in opt.params)]
    step = make_train_step(model, opt, refine, cfg["normalize_gap"], cfg["include_primal"],
                           cfg["normalize_costs"])
    st.stepper = BatchStepper(step, ctx.device, [st.spec], cfg["device_cache"])
    st.gen = torch.Generator(device=ctx.device).manual_seed(st.dropout_seed)

    # the checked steps, through the window's own call and feed
    start = [p.detach().clone() for p in opt.params]
    st.losses, st.changes = [], []
    outputs = []
    if ctx.variant == "greedy_order":
        from lapgnn_tpu_torch.train import loss as loss_module

        greedy_total = loss_module.greedy_total
        loss_module.greedy_total = lambda red, cost, order, valid: greedy_total(
            red, cost, torch.arange(order.shape[-1], device=order.device).expand_as(order)
            .contiguous(), valid)
    hooks = _capture(model, outputs)
    for s, idx in enumerate(_batches(st, CHECKED_STEPS)):
        if ctx.variant == "half_batch":
            idx = idx[: st.batch // 2]
        if ctx.variant == "unchanged":
            opt.step = lambda grads: None  # the step returns its state unchanged
        st.losses.append(float(st.stepper(st.spec, idx, st.gen)))
        if s == 0:
            st.first = {k: float(mu.norm()) / (1.0 - opt.b1) for k, mu in zip(st.names, opt.mu)}
            st.out = outputs[0]
            for hook in hooks:
                hook.remove()
        st.changes.append({k: float((p.detach() - p0).norm())
                           for k, p, p0 in zip(st.names, opt.params, start)})
    if ctx.variant == "unchanged":
        del opt.step
    if ctx.variant == "greedy_order":
        loss_module.greedy_total = greedy_total
    del start
    st.done = CHECKED_STEPS
    for idx in _batches(st, int(tr["warm_steps"]), CHECKED_STEPS * st.batch):
        st.stepper(st.spec, idx, st.gen)
        st.done += 1
    ctx.log(f"setup parts: pool and targets {t_targets!r} s, model and steps "
            f"{time.perf_counter() - t0 - t_targets!r} s; cached on the device: "
            f"{sorted(tuple(c.shape) for c, _ in st.stepper.caches.values())}")
    return st


def window(st: State, ctx) -> dict:
    stepper = st.stepper
    if ctx.spans is not None:
        stepper = ctx.spans.wrap(stepper, "step")
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    steps = 0
    t_open = time.perf_counter()
    while time.perf_counter() - t_open < ctx.seconds:
        stepper(st.spec, _batches(st, 1, (st.done + steps) * st.batch)[0], st.gen)
        steps += 1
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    window_s = time.perf_counter() - t_open
    return {"steps": steps, "samples": steps * st.batch, "window_s": window_s,
            "n": st.n, "batch": st.batch, "counts": {"steps": steps}}


def _reference_readings(st, ctx, tf32: bool, scale: float = 1.0):
    cfg = ctx.config
    raw = (ctx.root / cfg["checkpoint"] / "params.msgpack").read_bytes()
    params = {k: (v * np.float32(scale)).astype(v.dtype)
              for k, v in read_msgpack_params(raw).items()}
    ref = Reference(params, cfg["layers"], cfg["topk"], cfg["dropout"], float(cfg["lr"]),
                    cfg["weight_decay"], cfg["grad_clip"], ctx.device, greedy_upper, tf32=tf32)
    batches = [(torch.tensor(np.stack([st.pool_np[i] for i in idx]), device=ctx.device),
                torch.tensor(np.stack([st.u_np[i] for i in idx]), device=ctx.device))
               for idx in _batches(st, CHECKED_STEPS)]
    return ref.steps(batches, st.dropout_seed)


def _gap(a: float, b: float) -> float:
    if a != a:
        return float("inf")
    return abs(a - b) / abs(b) if b else (0.0 if a == b else float("inf"))


def _instance_gaps(out: torch.Tensor, ref: torch.Tensor) -> List[float]:
    """Each instance's relative gap between two outputs (B, 2n); an
    instance missing from ``out``, or with a NaN, reads infinity."""
    gaps = [float((out[b] - ref[b]).norm() / ref[b].norm()) for b in range(min(len(out), len(ref)))]
    return [g if g == g else float("inf") for g in gaps] + [float("inf")] * (len(ref) - len(gaps))


def check(st: State, rec: dict, ctx):
    st.model = st.opt = st.stepper = None
    serving.release()
    parts, first, changes = _reference_readings(st, ctx, tf32=False)
    moved = _reference_readings(st, ctx, False, 1.0 + ROUNDING)
    prog_out, prog_first, prog_changes, prog_losses = st.out, st.first, st.changes, st.losses
    if ctx.variant == "control":
        ctl_parts, prog_first, prog_changes = _reference_readings(st, ctx, tf32=True)
        prog_out, prog_losses = ctl_parts[0]["out"], [p["loss"] for p in ctl_parts]
    median = float(np.median(list(first.values())))
    counted = [k for k in first if first[k] >= 1e-3 * median]
    ctx.log("leaves left out (reference gradient under 1e-3 of the median leaf's): "
            + (", ".join(sorted(set(first) - set(counted))) or "none"))
    # a leaf of a change is held where rounding alone moves its norm by at
    # most CONDITIONED; the change after three steps only where that holds
    # most leaves
    kept = []
    for step in (0, CHECKED_STEPS - 1):
        leaf_reach = {k: _gap(moved[2][step][k], changes[step][k]) for k in counted}
        kept.append([k for k in counted if leaf_reach[k] <= CONDITIONED])
        ctx.log(f"leaves left out of the change after step {step + 1} (rounding moves them by "
                "more than CONDITIONED): "
                + json.dumps({k: r for k, r in leaf_reach.items() if r > CONDITIONED}))
    if 2 * len(kept[1]) < len(counted):
        kept[1] = []

    def change(prog, step, leaves):
        return yardstick.total_norm_gap(prog[step], changes[step], leaves) if leaves else 0.0

    # what rounding alone moves: instances, and the first gradient
    reach = _instance_gaps(moved[0][0]["out"], parts[0]["out"])
    held = [b for b, r in enumerate(reach) if r <= CONDITIONED]
    forward_each = _instance_gaps(prog_out.to(parts[0]["out"].device), parts[0]["out"])
    forward_gap = max((forward_each[b] for b in held), default=0.0)
    grad_reach = yardstick.median_leaf_gap(moved[1], first, counted)
    grad_median = yardstick.median_leaf_gap(prog_first, first, counted)
    grad_gap = grad_median if grad_reach <= CONDITIONED else 0.0
    change_each = [change(prog_changes, 0, kept[0]), change(prog_changes, -1, kept[1])]
    change_gap = max(change_each)
    loss_reach = _gap(moved[0][0]["loss"], parts[0]["loss"])
    loss_gap = _gap(prog_losses[0], parts[0]["loss"]) if loss_reach <= CONDITIONED else 0.0
    ctx.log(f"step losses program {prog_losses!r} reference "
            f"{[{k: v for k, v in p.items() if k != 'out'} for p in parts]!r}")
    ctx.log("readings " + json.dumps({
        "loss_gap_by_step": [_gap(a, b["loss"]) for a, b in zip(prog_losses, parts)],
        "loss_rounding_reach": loss_reach, "loss_gap": loss_gap,
        "forward_gap_each": forward_each, "rounding_reach_each": reach, "held": len(held),
        "forward_gap": forward_gap, "grad_gap_median_leaf": grad_median,
        "grad_rounding_reach": grad_reach, "grad_gap": grad_gap,
        "grad_gap_widest": yardstick.leaf_norm_gaps(prog_first, first, counted)[0],
        "change_gap": change_gap, "change_gap_by_step": change_each,
        "change_held": [len(h) for h in kept], "change_leaves": len(counted),
        "change_rounding_reach": [change(moved[2], 0, kept[0]), change(moved[2], -1, kept[1])],
        "change_gap_all_leaves": change(prog_changes, -1, counted),
        "change_rounding_reach_all_leaves": change(moved[2], -1, counted)}))
    lim = ctx.config["limits"]["train"]
    checks = [("forward_gap", forward_gap, lim["forward_gap"]),
              ("grad_gap", grad_gap, lim["grad_gap"]),
              ("change_gap", change_gap, lim["change_gap"]),
              ("loss_gap", loss_gap, lim["loss_gap"])]
    rec["attempted"] = CHECKED_STEPS + rec["steps"]
    return checks, CHECKED_STEPS if any(not v <= l for _, v, l in checks) else 0
