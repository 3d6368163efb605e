"""Large-scale benchmark: on-the-fly uniform instances at n in {4096..16384}.

Port of ``lapgnn_tpu/cli/large_scale_benchmark.py``, with ``--device``
(default ``cuda``; ``cpu`` runs on the CPU): generates uniform instances at
large sizes, times SciPy and the cold native JV (unless ``--no-baselines``)
and the warm-start pipeline, checks the pipeline's cost against SciPy's, and
reports time-against-size scaling ratios.

Example:
  python -m lapgnn_tpu_torch.cli.large_scale_benchmark --checkpoint artifacts/one_gnn_default \
      --sizes 4096 8192 16384 --mode hybrid
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", type=Path, default=None)
    p.add_argument("--sizes", type=int, nargs="+", default=[4096, 8192, 16384])
    p.add_argument("--instances", type=int, default=2)
    p.add_argument("--mode", choices=["device", "hybrid"], default="hybrid")
    p.add_argument(
        "--seed-mode", choices=["auto", "gnn", "rank1"], default="auto",
        help="dual-seed source: GNN, rank-1 analytic, or per-instance best (ops/rank1.py)",
    )
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--no-baselines", action="store_true")
    p.add_argument("--logs", type=Path, default=Path("logs"))
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import scipy.optimize
    import torch

    from ..bench.harness import time_rigorous
    from ..bench.logging_system import BenchmarkLogger
    from ..data.generators import generate_uniform_costs
    from ..solver.native import lapjv_native

    logger = BenchmarkLogger("large_scale", root=args.logs)

    pipe = None
    if args.checkpoint and not args.checkpoint.exists():
        raise FileNotFoundError(f"checkpoint not found: {args.checkpoint}")
    if args.checkpoint:
        from ..pipeline import WarmStartPipeline
        from ..train.checkpoint import build_model_from_meta, load_checkpoint

        params, meta, _ = load_checkpoint(args.checkpoint)
        model = build_model_from_meta(meta)
        pipe = WarmStartPipeline(
            model, params, mode=args.mode,
            use_cost_refinement=bool(meta.get("use_cost_refinement", True)),
            seed_mode=args.seed_mode,
            route="device",  # measure the requested mode, not the router
            device=args.device,
        )

    results = []
    for n in args.sizes:
        for k in range(args.instances):
            C = generate_uniform_costs(n, seed=1000 + k)
            row = {"n": n, "instance": k}

            opt = None
            if not args.no_baselines:
                s = time_rigorous(lambda: scipy.optimize.linear_sum_assignment(C), 1, args.repeats)
                logger.log_result("scipy", "uniform", n, s)
                if s["success"]:
                    row["scipy_s"] = s["median"]
                    r_, c_ = s["result"]  # the timed solve's result
                    opt = float(C[r_, c_].sum())
                else:
                    print(f"# scipy failed at n={n}: {s.get('error')}")
                s = time_rigorous(lambda: lapjv_native(C), 1, args.repeats)
                logger.log_result("lap_cold", "uniform", n, s)
                if s["success"]:
                    row["cold_s"] = s["median"]
                else:
                    print(f"# lap_cold failed at n={n}: {s.get('error')}")

            if pipe is not None:
                Cd = torch.from_numpy(np.asarray(C, np.float32))[None].to(pipe.device)
                s = time_rigorous(lambda: pipe.solve(Cd), 1, args.repeats)
                if not s["success"]:
                    print(f"# warm_pipeline failed at n={n}: {s.get('error')}")
                    logger.log_result("warm_pipeline", "uniform", n, s)
                if s["success"]:
                    got = float(s["result"]["cost"][0])
                    if opt is not None and not (abs(got - opt) < 1e-3 * max(1.0, abs(opt))):
                        # never publish the speedup of a wrong answer
                        raise RuntimeError(f"optimality violated at n={n}: {got} vs {opt}")
                    row["pipeline_s"] = s["median"]
                    if "scipy_s" in row:
                        row["speedup_vs_scipy"] = row["scipy_s"] / row["pipeline_s"]
                    logger.log_result(
                        "warm_pipeline", "uniform", n, s, cost=got,
                        speedup=row.get("speedup_vs_scipy"),
                    )
            results.append(row)
            print(json.dumps(row))

    # scaling ratios of the pipeline's time between consecutive sizes
    by_n = {}
    for r in results:
        if "pipeline_s" in r:
            by_n.setdefault(r["n"], []).append(r["pipeline_s"])
    sizes = sorted(by_n)
    scaling = {}
    for a, b in zip(sizes, sizes[1:]):
        ratio = float(np.median(by_n[b]) / np.median(by_n[a]))
        scaling[f"{a}->{b}"] = round(ratio, 3)
    summary = {"scaling_time_ratios": scaling} if scaling else {}
    logger.finalize(summary or None)
    if summary:
        print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
