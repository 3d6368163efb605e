"""The closed loop of ``solve_closed`` (loaded from its file) on a pipeline
that serves a DualGNN, with the model's outputs held to the reference.

One client calls ``WarmStartPipeline.solve(C)``, the default call without a
certificate, on the pool's host instances in the seeded order; every
request is timed from the call to the returned result.  Inside the window
the model's u of the first call on each pool instance is kept on the device
(``pipe.model.forward`` wrapped, as ``train_step._capture`` does), and the
program's ``dual_forward`` counter is read around each call: it must rise
by exactly one, so that the model ran on every request.

After the window the program is released and the answers are judged as
``solve_closed`` judges them (``opt_gap``, ``cost_err``); then each kept u
is held to the plain reference's forward on the same instance
(``reference.dual_gnn``, the checkpoint's own msgpack weights, float32,
TF32 off): ``u_gap``, the widest relative gap over the held instances.
What rounding alone sets is not held: the reference runs again from weights
moved by ``ROUNDING``, and an instance that this moves by more than
``CONDITIONED`` is left out (the sparse family, whose features saturate the
attention), the rule of the training cell's ``forward_gap``.

Variants, for the control and the fault tests (never in a benchmark run):
``control`` runs the program's matrix products in TF32, the precision below
the configuration's float32 with TF32 off; ``altered`` swaps two columns of
every answer where the call returns it; ``perturbed`` scales each kept u by
1 + 1e-3.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from lapbench import manifest, serving
from lapbench.reference.dual_gnn import forward, graph_features, read_msgpack_params

_closed = manifest.load_module(Path(__file__).with_name("solve_closed.py"),
                               "lapbench_entry_solve_closed")

ROUNDING = 2.0**-22  # the relative move of the reference's weights that reads rounding's reach
CONDITIONED = 1e-4  # the most that the move may shift a u that is held to the reference
PERTURBED = 1e-3


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _forwards() -> int:
    """The program's ``dual_forward`` count; 0 for a program without it."""
    try:
        from lapgnn_tpu_torch import tracing
    except ImportError:
        return 0
    return int(tracing.counters().get("dual_forward", 0))


def setup(ctx) -> _closed.State:
    cfg = ctx.config
    t0 = time.perf_counter()
    pool, order = serving.make_pool(ctx)
    t1 = time.perf_counter()
    pipe = serving.build_pipeline(ctx)
    _tf32(ctx.variant == "control")  # after the import of the program, which turns TF32 off
    model = pipe.model
    widths = (getattr(model, "hidden_dim", None), getattr(model, "num_layers", None),
              getattr(model, "heads", None))
    if widths != (cfg["hidden"], cfg["layers"], cfg["heads"]):
        raise ValueError(f"the checkpoint's model {type(model).__name__} {widths} is not the "
                         f"configuration's DualGNN ({cfg['hidden']}, {cfg['layers']}, {cfg['heads']})")
    t2 = time.perf_counter()
    for _, C in pool:  # every distinct instance once: the shapes and the libraries
        pipe.solve(C)
    ctx.log(f"setup parts: pool {t1 - t0!r} s, pipeline {t2 - t1!r} s, "
            f"warm-up {time.perf_counter() - t2!r} s; TF32 {torch.backends.cuda.matmul.allow_tf32}")
    return _closed.State(pool, order, pipe)


def window(st: _closed.State, ctx) -> dict:
    index = {id(C): i for i, (_, C) in enumerate(st.pool)}
    kept: Dict[int, torch.Tensor] = {}
    rises: List[int] = []
    current = [None]
    model, solve = st.pipe.model, st.pipe.solve
    model_forward = model.forward

    def captured(*args, **kwargs):
        out = model_forward(*args, **kwargs)
        if current[0] is not None and current[0] not in kept:
            kept[current[0]] = out["u"].detach().clone()
        return out

    def counted(C, **kwargs):
        current[0] = index.get(id(C))
        before = _forwards()
        try:
            return solve(C, **kwargs)
        finally:
            rises.append(_forwards() - before)
            current[0] = None

    model.forward = captured
    st.pipe.solve = counted
    try:
        rec = _closed.window(st, ctx)
    finally:
        del model.forward
        del st.pipe.solve
    rec["kept_u"], rec["forward_rises"] = kept, rises
    return rec


def _reference_u(ctx, costs: Dict[int, np.ndarray], scale: float = 1.0) -> Dict[int, torch.Tensor]:
    """The reference forward's u on each instance, from the checkpoint's
    weights times ``scale``, in float32 with TF32 off."""
    cfg = ctx.config
    raw = (ctx.root / cfg["checkpoint"] / "params.msgpack").read_bytes()
    params = {k: torch.tensor((v * np.float32(scale)).astype(np.float32), device=ctx.device)
              for k, v in read_msgpack_params(raw).items()}
    out = {}
    with torch.no_grad():
        for i, C in costs.items():
            row, col, edge = graph_features(torch.tensor(C, device=ctx.device)[None])
            u, _ = forward(params, row, col, edge, cfg["layers"], cfg["heads"], cfg["dropout"], None)
            out[i] = u[0]
            del row, col, edge
    return out


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    g = float((a.to(b.device, torch.float32) - b).norm() / b.norm())
    return g if g == g else float("inf")


def check(st: _closed.State, rec: dict, ctx):
    pool = st.pool
    by_call = [(pool[i][0], t) for (i, _, _), t in zip(rec["answers"], rec["latencies_ms"])]
    checks, _ = _closed.check(st, rec, ctx)  # releases the program, judges the answers
    _tf32(False)
    kept = rec.pop("kept_u")
    if ctx.variant == "perturbed":
        kept = {i: u * (1.0 + PERTURBED) for i, u in kept.items()}
    costs = {i: pool[i][1] for i in sorted(kept)}
    ref = _reference_u(ctx, costs)
    moved = _reference_u(ctx, costs, 1.0 + ROUNDING)
    reach = {i: _gap(moved[i], ref[i]) for i in costs}
    each = {i: _gap(kept[i][0], ref[i]) for i in costs}
    held = [i for i in costs if reach[i] <= CONDITIONED]
    u_gap = max((each[i] for i in held), default=0.0) if kept else float("inf")
    rises = np.asarray(rec["forward_rises"])
    misses = int((rises != 1).sum())
    families = sorted({pool[i][0] for i in costs})

    def by_family(values, agg):
        return {f: agg(values[i] for i in costs if pool[i][0] == f) for f in families}

    ctx.log("readings " + json.dumps({
        "u_gap": u_gap, "kept": len(kept), "calls": int(len(rises)), "dual_forward_misses": misses,
        "u_gap_by_family": by_family(each, max), "rounding_reach_by_family": by_family(reach, max),
        "held_by_family": by_family({i: int(i in held) for i in costs}, sum),
        "latency_ms_p50_by_family": {f: float(np.median([t for g, t in by_call if g == f]))
                                     for f in sorted({g for g, _ in by_call})}}))
    ok = rec["ok"] & (rises == 1)
    rec["latencies_ms"] = [t if good else float("inf") for t, good in zip(rec["latencies_ms"], ok)]
    rec["instances_ok"] = int(ok.sum())
    checks += [("u_gap", u_gap, ctx.config["limits"]["model"]["u_gap"]),
               ("dual_forward_misses", float(misses), 0.0)]
    return checks, int((~ok).sum())
