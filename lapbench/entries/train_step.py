"""Closed-loop optimizer steps of ``make_dual_train_step`` on batches of the
pool in the seeded order; the rate counts every sample of the steps the
window ran, over the window up to the device's end of its last step.

Set-up builds the one training object (model from the checkpoint, AdamW,
the step), makes the pool's target duals itself (the reference's float64
optimum and duals, not the program's), and drives the object through its
first steps; the first three are held to the reference: the first step's
regression term (its mean squared gap between v_hint and the min-trick's
v), its outputs u and v_hint of each instance, the first gradient's median
leaf, and, after the three, the whole change of the parameters.  What
rounding alone sets is not held: the reference runs a second time from
weights moved by ``ROUNDING``, and an instance, or the first gradient, that
this moves by more than ``CONDITIONED`` is left out (instances of the
sparse family, whose features saturate the attention at about 1e15, and the
gradient of any batch that holds one).  The losses are logged and not compared: the greedy
bound's near-ties make them jump at rounding-size changes of the outputs.

Variants, for the control and the fault tests (never in a benchmark run):
``control`` puts the reference computed in TF32 in the program's place
(the precision below the configuration's float32 with TF32 off);
``half_batch`` feeds the checked steps the first half of each batch;
``unchanged`` skips the optimizer's update in the checked steps.
"""

from __future__ import annotations

import json
import time
from typing import List

import numpy as np
import torch

from lapbench import families, serving, yardstick
from lapbench.reference import lap
from lapbench.reference.dual_gnn import Reference, read_msgpack_params

CHECKED_STEPS = 3
ROUNDING = 2.0**-22  # the relative move of the reference's weights that reads rounding's reach
CONDITIONED = 1e-4  # the most that the move may shift a number that is held to the reference


class State:
    pass


def _flax_name(torch_name: str) -> str:
    """``layer.0.row_proj.weight`` -> ``layer_0/row_proj/kernel``; a
    LayerNorm's weight is its ``scale``."""
    parts = torch_name.split(".")
    if parts[0] == "layer":
        parts = [f"layer_{parts[1]}"] + parts[2:]
    if parts[-1] == "weight":
        parts[-1] = "scale" if "norm" in parts[-2] else "kernel"
    return "/".join(parts)


def _capture(forward, outputs: List[torch.Tensor]):
    """``forward`` that also keeps its outputs u and v_hint, side by side."""

    def captured(*args, **kwargs):
        out = forward(*args, **kwargs)
        outputs.append(torch.cat([out["u"], out["v_hint"]], -1).detach().clone())
        return out

    return captured


def _batches(st, count: int, offset: int = 0) -> List[List[int]]:
    B, order = st.batch, st.order
    return [[int(order[(offset + s * B + j) % len(order)]) for j in range(B)] for s in range(count)]


def setup(ctx) -> State:
    from lapgnn_tpu_torch.train.checkpoint import load_checkpoint
    from lapgnn_tpu_torch.train.convert import params_from_flax
    from lapgnn_tpu_torch.train.dual_trainer import build_dual_gnn, make_dual_train_step
    from lapgnn_tpu_torch.train.schedule import make_optimizer

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
    st.cost = torch.tensor(np.stack(st.pool_np), device=ctx.device)
    st.u = torch.tensor(np.stack(st.u_np), device=ctx.device)
    st.dropout_seed = int(np.random.default_rng([ctx.seed, 7]).integers(0, 2**62))
    t_targets = time.perf_counter() - t0

    params, _, _ = load_checkpoint(ctx.root / cfg["checkpoint"])
    model = build_dual_gnn(cfg["hidden"], cfg["layers"], cfg["heads"], cfg["dropout"], 0, ctx.device)
    model.load_state_dict(params_from_flax(params))
    model.train()
    opt = make_optimizer(list(model.parameters()), float(cfg["lr"]), cfg["weight_decay"],
                         cfg["grad_clip"])
    st.model, st.opt = model, opt
    st.names = [_flax_name(name) for name, _ in model.named_parameters()]
    st.step = make_dual_train_step(model, opt, cfg["clip_sentinels"], cfg["normalize_gap"],
                                   cfg["supervise_duals"])
    st.gen = torch.Generator().manual_seed(st.dropout_seed)

    # the checked steps, through the window's own call and feed
    start = [p.detach().clone() for p in opt.params]
    st.parts, st.changes = [], []
    outputs = []
    model.forward = _capture(model.forward, outputs)
    for s, idx in enumerate(_batches(st, CHECKED_STEPS)):
        cost, u = st.cost[idx], st.u[idx]
        if ctx.variant == "half_batch":
            cost, u = cost[: st.batch // 2], u[: st.batch // 2]
        if ctx.variant == "unchanged":
            opt.step = lambda grads: None  # the step returns its state unchanged
        m = st.step(cost, u, st.gen)
        st.parts.append({"loss": float(m["loss"]), "v_mse": float(m["v_mse_mean"]),
                         "feas": float(m["feas_mean"]), "primal_gap": float(m["primal_gap_mean"])})
        if s == 0:
            st.first = {k: float(mu.norm()) / (1.0 - opt.b1) for k, mu in zip(st.names, opt.mu)}
            st.parts[0]["out"] = outputs[0]
            del model.forward
        st.changes.append({k: float((p.detach() - p0).norm())
                           for k, p, p0 in zip(st.names, opt.params, start)})
    if ctx.variant == "unchanged":
        del opt.step
    del start
    st.done = CHECKED_STEPS
    for idx in _batches(st, int(tr["warm_steps"]), CHECKED_STEPS * st.batch):
        st.step(st.cost[idx], st.u[idx], st.gen)
        st.done += 1
    ctx.log(f"setup parts: pool and targets {t_targets!r} s, model and steps "
            f"{time.perf_counter() - t0 - t_targets!r} s")
    return st


def window(st: State, ctx) -> dict:
    if ctx.spans is not None:
        st.model.forward = ctx.spans.wrap(st.model.forward, "forward")
        st.opt.step = ctx.spans.wrap(st.opt.step, "optimizer")
        st.step = ctx.spans.wrap(st.step, "step")
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    steps = 0
    t_open = time.perf_counter()
    while time.perf_counter() - t_open < ctx.seconds:
        idx = _batches(st, 1, (st.done + steps) * st.batch)[0]
        st.step(st.cost[idx], st.u[idx], st.gen)
        steps += 1
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    window_s = time.perf_counter() - t_open
    return {"steps": steps, "samples": steps * st.batch, "window_s": window_s,
            "n": st.n, "batch": st.batch, "counts": {"steps": steps}}


def _reference_readings(st, ctx, tf32: bool, scale: float = 1.0):
    cfg = ctx.config
    raw = (ctx.root / cfg["checkpoint"] / "params.msgpack").read_bytes()
    params = {k: (v * np.float32(scale)).astype(v.dtype) for k, v in read_msgpack_params(raw).items()}
    ref = Reference(params, cfg["layers"], cfg["heads"], cfg["dropout"],
                    float(cfg["lr"]), cfg["weight_decay"], cfg["grad_clip"], ctx.device)
    batches = [(torch.tensor(np.stack([st.pool_np[i] for i in idx]), device=ctx.device),
                torch.tensor(np.stack([st.u_np[i] for i in idx]), device=ctx.device))
               for idx in _batches(st, CHECKED_STEPS)]
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        return ref.steps(batches, st.dropout_seed)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if a == a else float("inf")


def _instance_gaps(out: torch.Tensor, ref: torch.Tensor) -> List[float]:
    """Each instance's relative gap between two outputs (B, n + m); an
    instance missing from ``out``, or with a NaN, reads infinity."""
    gaps = [float((out[b] - ref[b]).norm() / ref[b].norm()) for b in range(min(len(out), len(ref)))]
    return [g if g == g else float("inf") for g in gaps] + [float("inf")] * (len(ref) - len(gaps))


def check(st: State, rec: dict, ctx):
    st.model = st.opt = st.step = st.cost = st.u = None
    serving.release()
    parts, first, changes = _reference_readings(st, ctx, tf32=False)
    moved = _reference_readings(st, ctx, False, 1.0 + ROUNDING)
    prog_parts, prog_first, prog_changes = st.parts, st.first, st.changes
    if ctx.variant == "control":
        prog_parts, prog_first, prog_changes = _reference_readings(st, ctx, tf32=True)
    median = float(np.median(list(first.values())))
    counted = [k for k in first if first[k] >= 1e-3 * median]
    ctx.log("leaves left out (reference gradient under 1e-3 of the median leaf's): "
            + (", ".join(sorted(set(first) - set(counted))) or "none"))
    # what rounding alone moves: instances, and the first gradient
    reach = _instance_gaps(moved[0][0]["out"], parts[0]["out"])
    held = [b for b, r in enumerate(reach) if r <= CONDITIONED]
    forward_each = _instance_gaps(prog_parts[0]["out"].to(parts[0]["out"].device), parts[0]["out"])
    forward_gap = max((forward_each[b] for b in held), default=0.0)
    grad_reach = yardstick.median_leaf_gap(moved[1], first, counted)
    grad_median = yardstick.median_leaf_gap(prog_first, first, counted)
    grad_gap = grad_median if grad_reach <= CONDITIONED else 0.0
    change_gap = yardstick.total_norm_gap(prog_changes[-1], changes[-1], counted)
    vreg_gap = _gap(prog_parts[0]["v_mse"], parts[0]["v_mse"])
    ctx.log(f"step parts program {_no_out(prog_parts)!r} reference {_no_out(parts)!r}")
    ctx.log("readings " + json.dumps({
        "loss_gap_by_step": [_gap(a["loss"], b["loss"]) for a, b in zip(prog_parts, parts)],
        "vreg_gap": vreg_gap, "forward_gap_each": forward_each, "rounding_reach_each": reach,
        "forward_gap": forward_gap, "grad_gap_median_leaf": grad_median,
        "grad_rounding_reach": grad_reach, "grad_gap": grad_gap,
        "grad_gap_widest": yardstick.leaf_norm_gaps(prog_first, first, counted)[0],
        "change_gap": change_gap,
        "change_gap_widest": yardstick.leaf_norm_gaps(prog_changes[-1], changes[-1], counted)[0],
        "change_gap_median_leaf": yardstick.median_leaf_gap(prog_changes[-1], changes[-1], counted),
        "change_rounding_reach": yardstick.total_norm_gap(moved[2][-1], changes[-1], counted)}))
    lim = ctx.config["limits"]["train"]
    checks = [("vreg_gap", vreg_gap, lim["vreg_gap"]),
              ("forward_gap", forward_gap, lim["forward_gap"]),
              ("grad_gap", grad_gap, lim["grad_gap"]),
              ("change_gap", change_gap, lim["change_gap"])]
    rec["attempted"] = CHECKED_STEPS + rec["steps"]
    return checks, CHECKED_STEPS if any(not v <= l for _, v, l in checks) else 0


def _no_out(parts):
    return [{k: v for k, v in p.items() if k != "out"} for p in parts]
