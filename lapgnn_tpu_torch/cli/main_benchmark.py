"""Solver-only benchmark (no GNN): oracle-dual warm starts against baselines.

Port of ``lapgnn_tpu/cli/main_benchmark.py``: four test groups (uniform n in
{200, 500, 1000}, noise sensitivity at noise 0 / 0.1 / 0.2, near-diagonal,
sparse), each gated by the cross-solver correctness check before timing,
with the assessment tiers (>= 2.0x excellent / >= 1.1x good / >= 0.9x
neutral / below poor).  Host only, as the JAX CLI: the gate is
``verify_solver_correctness``'s default set (SciPy, native cold, native
seeded) and every timed solve runs on the host.

Example:
  python -m lapgnn_tpu_torch.cli.main_benchmark            # full run
  python -m lapgnn_tpu_torch.cli.main_benchmark --quick    # 1 size, fewer repeats
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--warmups", type=int, default=3)
    p.add_argument("--logs", type=Path, default=Path("logs"))
    return p


def _tier(speedup: float) -> str:
    if speedup >= 2.0:
        return "excellent"
    if speedup >= 1.1:
        return "good"
    if speedup >= 0.9:
        return "neutral"
    return "poor"


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.quick:
        args.repeats, args.warmups = 3, 1

    import scipy.optimize

    from ..bench.harness import time_rigorous
    from ..bench.logging_system import BenchmarkLogger
    from ..data.generators import (
        generate_near_diagonal_costs,
        generate_sparse_costs,
        generate_uniform_costs,
    )
    from ..ops.host_dual import oracle_duals_np, project_feasible_np
    from ..solver.native import lapjv_native, lapjv_seeded_native
    from ..solver.verification import verify_solver_correctness

    logger = BenchmarkLogger("main_benchmark", root=args.logs)
    sizes = [200] if args.quick else [200, 500, 1000]

    groups = []
    for n in sizes:
        groups.append(("uniform", n, generate_uniform_costs(n, seed=n), 0.0))
    for noise in (0.0, 0.1, 0.2):
        n = 500 if not args.quick else 200
        groups.append((f"uniform_noise{noise}", n, generate_uniform_costs(n, seed=7), noise))
    n = sizes[-1]
    groups.append(("near_diagonal", n, generate_near_diagonal_costs(n, seed=3), 0.0))
    groups.append(("sparse", n, generate_sparse_costs(n, seed=4), 0.0))

    rows = []
    for name, n, C, noise in groups:
        u, v = oracle_duals_np(C, noise_level=noise)
        if noise > 0:
            u, v = project_feasible_np(C, u, v)
        # the correctness gate before any timing
        verify_solver_correctness(C, u=u, v=v)

        s_scipy = time_rigorous(
            lambda: scipy.optimize.linear_sum_assignment(C), args.warmups, args.repeats
        )
        s_cold = time_rigorous(lambda: lapjv_native(C), args.warmups, args.repeats)
        s_seed = time_rigorous(lambda: lapjv_seeded_native(C, u, v), args.warmups, args.repeats)
        if not (s_scipy["success"] and s_cold["success"] and s_seed["success"]):
            # a failed measurement has no 'median': log what there is, go on
            for nm, st in (("scipy", s_scipy), ("lap_cold", s_cold), ("seeded", s_seed)):
                logger.log_result(nm, name, n, st)
            print(f"# {name} n={n}: measurement failed, skipping row")
            continue
        sp_scipy = s_scipy["median"] / s_seed["median"]
        sp_cold = s_cold["median"] / s_seed["median"]
        logger.log_result("scipy", name, n, s_scipy)
        logger.log_result("lap_cold", name, n, s_cold)
        logger.log_result("seeded", name, n, s_seed, speedup=sp_scipy)
        row = {
            "group": name,
            "n": n,
            "scipy_ms": round(s_scipy["median"] * 1e3, 3),
            "cold_ms": round(s_cold["median"] * 1e3, 3),
            "seeded_ms": round(s_seed["median"] * 1e3, 3),
            "speedup_vs_scipy": round(sp_scipy, 3),
            "speedup_vs_cold": round(sp_cold, 3),
            "assessment": _tier(sp_scipy),
        }
        rows.append(row)
        print(json.dumps(row))

    summary = {
        "mean_speedup_vs_scipy": float(np.mean([r["speedup_vs_scipy"] for r in rows])),
        "mean_speedup_vs_cold": float(np.mean([r["speedup_vs_cold"] for r in rows])),
    }
    logger.finalize(summary)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
