"""What the serving cells share: the instance pool, the pipeline as the
configuration states it, and the judging of the answers against the
reference's float64 optima."""

from __future__ import annotations

import gc
import json
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from lapbench import families
from lapbench.reference import lap

__all__ = ["add_counts", "build_pipeline", "judge", "make_pool", "release"]


def add_counts(counts: Dict[str, int], stats_list, out: Dict[str, np.ndarray]) -> None:
    """Add a call's solver loop counts (``last_solve_stats``) and its
    fallbacks to ``counts``."""
    from lapgnn_tpu_torch.solver.jv import DEVICE_COUNTS

    for stats in stats_list:
        for name in DEVICE_COUNTS + ("host_syncs",):
            counts[name] = counts.get(name, 0) + int(getattr(stats, name))
    counts["used_fallback"] = counts.get("used_fallback", 0) + int(np.sum(out["used_fallback"]))


def make_pool(ctx) -> Tuple[List[Tuple[str, np.ndarray]], np.ndarray]:
    """The traffic's pool of host instances (``families``: name -> count,
    in the file's order) and the seeded order in which the window cycles
    it."""
    names = [fam for fam, count in ctx.traffic["families"].items() for _ in range(int(count))]
    pool = families.draw(names, int(ctx.traffic["n"]), ctx.seed, np.dtype(ctx.traffic["dtype"]))
    order = np.random.default_rng([ctx.seed, 1 << 20]).permutation(len(pool))
    return pool, order


def build_pipeline(ctx, **overrides):
    """``WarmStartPipeline`` with the configuration's checkpoint and
    settings, the traffic's and then ``overrides`` on top."""
    from lapgnn_tpu_torch.pipeline import WarmStartPipeline
    from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint

    params, meta, _ = load_checkpoint(ctx.root / ctx.config["checkpoint"])
    kwargs = dict(ctx.config["pipeline"])
    kwargs.update(ctx.traffic.get("pipeline", {}))
    kwargs.update(overrides)
    return WarmStartPipeline(build_model_from_meta(meta), params, device=ctx.device, **kwargs)


def release() -> None:
    """Free what the program left on the card before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def judge(pool: Sequence[Tuple[str, np.ndarray]], answers: Sequence[Tuple[int, np.ndarray, float]],
          limits: Dict[str, float], log) -> Tuple[List[Tuple[str, float, float]], np.ndarray]:
    """Hold every answer (pool index, assignment, reported cost) to the
    reference: a permutation, its float64 cost above the float64 optimum by
    at most ``limits['opt_gap']`` a row (absolute: the solver's guarantee is
    a tolerance on each matched edge's reduced cost), and the reported cost
    within ``limits['cost_err']`` of its assignment's float64 cost
    (relative).  Returns the checks (name, widest reading, limit) and which
    answers passed."""
    optima = lap.optima([C for _, C in pool])
    n = pool[0][1].shape[0]
    gaps, errs, ok = [], [], []
    by_family: Dict[str, float] = {}
    for i, x, reported in answers:
        C = pool[i][1]
        opt = optima[i][0]
        if not lap.is_permutation(x, n):
            gap = err = float("inf")
        else:
            cost = lap.assignment_cost(C, x)
            gap = (cost - opt) / n
            err = abs(reported - cost) / max(abs(cost), 1e-300)
        gaps.append(gap)
        errs.append(err)
        ok.append(gap <= limits["opt_gap"] and err <= limits["cost_err"])
        fam = pool[i][0]
        by_family[fam] = max(by_family.get(fam, 0.0), gap)
    log("readings " + json.dumps({"opt_gap": max(gaps, default=0.0), "cost_err": max(errs, default=0.0),
                                  "opt_gap_by_family": by_family}))
    checks = [("opt_gap", max(gaps, default=0.0), limits["opt_gap"]),
              ("cost_err", max(errs, default=0.0), limits["cost_err"])]
    return checks, np.asarray(ok, bool)
