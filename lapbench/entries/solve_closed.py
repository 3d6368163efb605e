"""One client in a closed loop calling ``WarmStartPipeline.solve(C)``, the
default call without a certificate, on the pool's host instances in the
seeded order; every request is timed from the call to the returned result.

Variants, for the control and the fault tests (never in a benchmark run):
``control`` serves through the program's own bfloat16 transfer, the
precision below the configuration's float32; ``altered`` swaps two columns
of every answer where the call returns it.
"""

from __future__ import annotations

import time

from lapbench import serving


class State:
    def __init__(self, pool, order, pipe):
        self.pool, self.order, self.pipe = pool, order, pipe


def setup(ctx) -> State:
    t0 = time.perf_counter()
    pool, order = serving.make_pool(ctx)
    t1 = time.perf_counter()
    overrides = {"transfer_dtype": "bfloat16"} if ctx.variant == "control" else {}
    pipe = serving.build_pipeline(ctx, **overrides)
    t2 = time.perf_counter()
    for _, C in pool:  # every distinct instance once: the shapes and the libraries
        pipe.solve(C)
    ctx.log(f"setup parts: pool {t1 - t0!r} s, pipeline {t2 - t1!r} s, "
            f"warm-up {time.perf_counter() - t2!r} s")
    return State(pool, order, pipe)


def _solve(st: State, ctx):
    solve = st.pipe.solve
    if ctx.variant != "altered":
        return solve

    def altered(C, **kw):
        out = solve(C, **kw)
        out["col_of_row"][0, [0, 1]] = out["col_of_row"][0, [1, 0]]
        return out

    return altered


def window(st: State, ctx) -> dict:
    import lapgnn_tpu_torch.pipeline as pipeline_mod

    spans = ctx.spans
    orig_solver = pipeline_mod.lapjv_seeded_single
    if spans is not None:
        st.pipe._predict = spans.wrap(st.pipe._predict, "predict")
        pipeline_mod.lapjv_seeded_single = spans.wrap(orig_solver, "device_solve")
    solve = _solve(st, ctx)
    if spans is not None:
        solve = spans.wrap(solve, "solve_call")
    latencies, answers, counts = [], [], {}
    n_pool = len(st.order)
    try:
        t_open = time.perf_counter()
        k = 0
        while time.perf_counter() - t_open < ctx.seconds:
            i = int(st.order[k % n_pool])
            t0 = time.perf_counter()
            out = solve(st.pool[i][1])
            latencies.append((time.perf_counter() - t0) * 1e3)
            answers.append((i, out["col_of_row"][0].copy(), float(out["cost"][0])))
            if spans is not None:
                serving.add_counts(counts, st.pipe.last_solve_stats, out)
            k += 1
        window_s = time.perf_counter() - t_open
    finally:
        pipeline_mod.lapjv_seeded_single = orig_solver
    return {"latencies_ms": latencies, "answers": answers, "window_s": window_s,
            "instances": len(answers), "attempted": len(answers), "n": int(ctx.traffic["n"]), "batch": 1,
            "counts": counts}


def check(st: State, rec: dict, ctx):
    pool = st.pool
    st.pipe = None
    serving.release()
    checks, ok = serving.judge(pool, rec["answers"], ctx.config["limits"]["solve"], ctx.log)
    rec["ok"] = ok
    rec["latencies_ms"] = [t if good else float("inf") for t, good in zip(rec["latencies_ms"], ok)]
    rec["instances_ok"] = int(ok.sum())
    return checks, int((~ok).sum())
