"""GNN warm-start benchmark CLI.

Port of ``lapgnn_tpu/cli/benchmark.py``, with ``--device`` (default
``cuda``; ``cpu`` runs on the CPU): per instance, times SciPy, the cold
native JV and the warm-start pipeline (device or hybrid mode; without a
checkpoint, the native seeded solve from a non-learned seed), checks that
the pipeline's cost is SciPy's optimum, and logs CSV / JSON through
``BenchmarkLogger``.  The pipeline is handed a float32 batch already on its
device, as the JAX CLI hands it a device array.

Example:
  python -m lapgnn_tpu_torch.cli.benchmark --checkpoint artifacts/one_gnn_default \
      --sizes 512 2048 --families uniform sparse --instances 3 --mode hybrid
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", type=Path, default=None)
    p.add_argument("--sizes", type=int, nargs="+", default=[512, 2048])
    p.add_argument("--families", nargs="+", default=["uniform"])
    p.add_argument("--instances", type=int, default=3)
    p.add_argument("--mode", choices=["device", "hybrid"], default="hybrid")
    p.add_argument(
        "--transfer-dtype",
        choices=["float32", "bfloat16", "float16", "uint16", "topk16"],
        default="float32",
        help="host->device transfer encoding for mode=device (topk16: each "
             "row's 64 smallest entries; see pipeline.quantize_topk16)",
    )
    p.add_argument(
        "--seed-mode", choices=["auto", "gnn", "rank1"], default="auto",
        help="dual-seed source: GNN, rank-1 analytic, or per-instance best (ops/rank1.py)",
    )
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--warmups", type=int, default=2)
    p.add_argument("--seed-baseline", choices=["none", "row_col_minima", "rank1_analytic", "oracle"],
                   default="none", help="non-learned seed source when no checkpoint is given")
    p.add_argument("--logs", type=Path, default=Path("logs"))
    p.add_argument("--quick", action="store_true", help="1 instance, 2 repeats")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.quick:
        args.instances, args.repeats, args.warmups = 1, 2, 1

    import scipy.optimize
    import torch

    from ..bench.harness import time_rigorous
    from ..bench.logging_system import BenchmarkLogger
    from ..data.generators import FAMILIES
    from ..ops.host_dual import oracle_duals_np
    from ..solver.native import lapjv_native, lapjv_seeded_native
    from ..solver.seed_baselines import seed_rank1_analytic, seed_row_col_minima

    pipe = None
    if args.checkpoint and not args.checkpoint.exists():
        # a mistyped checkpoint must not fall back to the zero seed and be
        # logged as the pipeline's speedups
        raise FileNotFoundError(f"checkpoint not found: {args.checkpoint}")
    if args.checkpoint:
        from ..pipeline import WarmStartPipeline
        from ..train.checkpoint import build_model_from_meta, load_checkpoint

        params, meta, _ = load_checkpoint(args.checkpoint)
        model = build_model_from_meta(meta)
        pipe = WarmStartPipeline(
            model,
            params,
            mode=args.mode,
            use_cost_refinement=bool(meta.get("use_cost_refinement", True)),
            seed_mode=args.seed_mode,
            transfer_dtype=(args.transfer_dtype if args.mode == "device" else "float32"),
            # this CLI measures the requested mode; size routing would swap
            # in the host backend at small n
            route="device",
            device=args.device,
        )

    logger = BenchmarkLogger("gnn_benchmark", root=args.logs)
    rng = np.random.default_rng(0)
    summary_rows = []

    for fam in args.families:
        for n in args.sizes:
            for k in range(args.instances):
                C = FAMILIES[fam](n, rng)

                s_scipy = time_rigorous(
                    lambda: scipy.optimize.linear_sum_assignment(C),
                    args.warmups,
                    args.repeats,
                )
                if not s_scipy["success"]:
                    print(f"# scipy failed on {fam} n={n}: {s_scipy.get('error')}")
                    continue
                r, c = s_scipy["result"]  # the timed solve's result
                opt = float(C[r, c].sum())
                logger.log_result("scipy", fam, n, s_scipy, cost=opt)

                s_cold = time_rigorous(lambda: lapjv_native(C), args.warmups, args.repeats)
                logger.log_result("lap_cold", fam, n, s_cold,
                                  cost=s_cold["result"][2] if s_cold["success"] else None)

                if pipe is not None:
                    Cd = torch.from_numpy(np.asarray(C, np.float32))[None].to(pipe.device)
                    fn = lambda: pipe.solve(Cd)  # noqa: E731
                else:
                    if args.seed_baseline == "oracle":
                        u, v = oracle_duals_np(C)
                    elif args.seed_baseline == "row_col_minima":
                        u, v = seed_row_col_minima(C)
                    elif args.seed_baseline == "rank1_analytic":
                        u, v = seed_rank1_analytic(C)
                    else:
                        u, v = np.zeros(n), np.zeros(n)
                    fn = lambda: lapjv_seeded_native(C, u, v)  # noqa: E731
                s_pipe = time_rigorous(fn, args.warmups, args.repeats)
                if not s_pipe["success"]:
                    # a run where every solve failed must not look like one
                    # that measured nothing
                    print(f"# warm_pipeline FAILED on {fam} n={n} #{k}: {s_pipe.get('error')}")
                    logger.log_result("warm_pipeline", fam, n, s_pipe)
                if s_pipe["success"]:
                    res = s_pipe["result"]
                    got = float(res["cost"][0]) if isinstance(res, dict) else float(res[2])
                    if not (abs(got - opt) < 1e-3 * max(1.0, abs(opt))):
                        # an explicit raise: a bare assert vanishes under -O
                        raise RuntimeError(f"optimality violated: {got} vs {opt} ({fam} n={n})")
                    sp_scipy = s_scipy["median"] / s_pipe["median"]
                    sp_cold = (
                        s_cold["median"] / s_pipe["median"] if s_cold["success"] else float("nan")
                    )
                    logger.log_result(
                        "warm_pipeline", fam, n, s_pipe, cost=got, speedup=sp_scipy,
                        notes=f"vs_cold={sp_cold:.3f}",
                    )
                    summary_rows.append(
                        {"family": fam, "n": n, "speedup_vs_scipy": sp_scipy,
                         "speedup_vs_cold": sp_cold}
                    )
                    print(
                        f"{fam} n={n} #{k}: scipy={s_scipy['median']*1e3:.1f}ms "
                        f"cold={s_cold['median']*1e3:.1f}ms pipe={s_pipe['median']*1e3:.1f}ms "
                        f"speedup={sp_scipy:.2f}x (vs cold {sp_cold:.2f}x)"
                    )

    sp = [row["speedup_vs_scipy"] for row in summary_rows]
    summary = {
        "mean_speedup_vs_scipy": float(np.mean(sp)) if sp else None,
        "median_speedup_vs_scipy": float(np.median(sp)) if sp else None,
        "measured_instances": len(sp),
    }
    # finalised unconditionally: a run where every solve failed still writes
    # the experiment JSON with the failure rows
    logger.finalize(summary)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
