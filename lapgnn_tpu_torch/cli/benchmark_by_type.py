"""Per-family benchmark with rankings.

Port of ``lapgnn_tpu/cli/benchmark_by_type.py``, with ``--device`` (default
``cuda``; ``cpu`` runs on the CPU): groups instances by cost family and
reports per-family speedup, dual-MAE and fallback tables plus the best and
worst families, through the hybrid pipeline.

Example:
  python -m lapgnn_tpu_torch.cli.benchmark_by_type --checkpoint artifacts/one_gnn_default \
      --families uniform sparse metric tie clustered --size 512
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", type=Path, required=True)
    p.add_argument(
        "--seed-mode", choices=["auto", "gnn", "rank1"], default="auto",
        help="dual-seed source: GNN, rank-1 analytic, or per-instance best (ops/rank1.py)",
    )
    p.add_argument(
        "--families", nargs="+",
        default=["uniform", "sparse", "metric", "tie", "clustered", "noisy_linear"],
    )
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--instances", type=int, default=3)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--logs", type=Path, default=Path("logs"))
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import scipy.optimize
    import torch

    from ..bench.harness import time_rigorous
    from ..bench.logging_system import BenchmarkLogger
    from ..data.generators import FAMILIES
    from ..ops.host_dual import oracle_duals_np
    from ..pipeline import WarmStartPipeline
    from ..train.checkpoint import build_model_from_meta, load_checkpoint

    params, meta, _ = load_checkpoint(args.checkpoint)
    model = build_model_from_meta(meta)
    pipe = WarmStartPipeline(
        model, params, mode="hybrid",
        use_cost_refinement=bool(meta.get("use_cost_refinement", True)),
        seed_mode=args.seed_mode,
        device=args.device,
    )

    logger = BenchmarkLogger("by_type", root=args.logs)
    rng = np.random.default_rng(0)
    per_family = {}

    for fam in args.families:
        speedups, maes, gauge_maes, fallbacks = [], [], [], []
        for k in range(args.instances):
            C = FAMILIES[fam](args.size, rng)
            s_scipy = time_rigorous(
                lambda: scipy.optimize.linear_sum_assignment(C), 1, args.repeats
            )
            Cd = torch.from_numpy(np.asarray(C, np.float32))[None].to(pipe.device)
            u_pred, v_pred = pipe.predict_duals(Cd)
            u_np = u_pred[0].cpu().numpy().astype(np.float64)
            u_star, v_star = oracle_duals_np(C)
            maes.append(float(np.mean(np.abs(u_np - u_star))))
            # duals are defined up to a constant shift (u + c, v - c):
            # remove it before comparing shapes
            du = u_np - u_star
            gauge_maes.append(float(np.mean(np.abs(du - du.mean()))))

            s_pipe = time_rigorous(lambda: pipe.solve(Cd), 1, args.repeats)
            if s_pipe["success"]:
                # used_fallback from the timed solve itself
                fallbacks.append(bool(s_pipe["result"]["used_fallback"][0]))
            if s_pipe["success"] and s_scipy["success"]:
                sp = s_scipy["median"] / s_pipe["median"]
                speedups.append(sp)
                logger.log_result("warm_pipeline", fam, args.size, s_pipe, speedup=sp)

        per_family[fam] = {
            "speedup_mean": float(np.mean(speedups)) if speedups else None,
            "u_mae_mean": float(np.mean(maes)),
            "u_mae_gauge_mean": float(np.mean(gauge_maes)),
            "fallback_rate": float(np.mean(fallbacks)),
        }
        print(f"{fam}: {json.dumps(per_family[fam])}")

    ranked = sorted(
        (f for f in per_family if per_family[f]["speedup_mean"]),
        key=lambda f: -per_family[f]["speedup_mean"],
    )
    summary = {
        "per_family": per_family,
        "best_family": ranked[0] if ranked else None,
        "worst_family": ranked[-1] if ranked else None,
    }
    logger.finalize(summary)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
