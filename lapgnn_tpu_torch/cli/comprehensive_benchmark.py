"""Comprehensive benchmark with CSV output and matplotlib figures.

Port of ``lapgnn_tpu/cli/comprehensive_benchmark.py``, with ``--device``
(default ``cuda``; ``cpu`` runs on the CPU): filters families (default
sparse and uniform), records per-instance timing breakdowns including the
primal gap in %% against SciPy's cost, writes a CSV, and renders speedup
histograms, stage-breakdown bars and speedup-against-size scatter plots
(matplotlib is imported only there; ``--no-plots`` skips them).

Example:
  python -m lapgnn_tpu_torch.cli.comprehensive_benchmark --checkpoint artifacts/one_gnn_default \
      --families uniform sparse --sizes 512 1024 2048 --out logs/comprehensive
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", type=Path, required=True)
    p.add_argument("--families", nargs="+", default=["uniform", "sparse"])
    p.add_argument("--sizes", type=int, nargs="+", default=[512, 1024, 2048])
    p.add_argument("--instances", type=int, default=3)
    p.add_argument("--mode", choices=["device", "hybrid"], default="device")
    p.add_argument(
        "--seed-mode", choices=["auto", "gnn", "rank1"], default="auto",
        help="dual-seed source: GNN, rank-1 analytic, or per-instance best (ops/rank1.py)",
    )
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--out", type=Path, default=Path("logs/comprehensive"))
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def _plots(rows, out: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    speedups = [r["speedup_vs_scipy"] for r in rows]
    fig, axes = plt.subplots(1, 3, figsize=(16, 4.5))

    axes[0].hist(speedups, bins=20, color="#4C72B0", edgecolor="white")
    axes[0].axvline(1.0, color="red", ls="--", lw=1)
    axes[0].set_title("End-to-end speedup vs SciPy")
    axes[0].set_xlabel("speedup (x)")
    axes[0].set_ylabel("instances")

    stages = ("gnn_ms", "solve_ms")
    by_n = {}
    for r in rows:
        by_n.setdefault(r["n"], []).append(r)
    ns = sorted(by_n)
    bottoms = np.zeros(len(ns))
    for stage in stages:
        vals = [float(np.mean([r[stage] for r in by_n[n]])) for n in ns]
        axes[1].bar([str(n) for n in ns], vals, bottom=bottoms, label=stage)
        bottoms += np.asarray(vals)
    axes[1].set_title("Pipeline time breakdown by size")
    axes[1].set_ylabel("ms")
    axes[1].legend()

    for fam in sorted({r["family"] for r in rows}):
        pts = [(r["n"], r["speedup_vs_scipy"]) for r in rows if r["family"] == fam]
        axes[2].scatter([p[0] for p in pts], [p[1] for p in pts], label=fam, alpha=0.7)
    axes[2].set_xscale("log", base=2)
    axes[2].axhline(1.0, color="red", ls="--", lw=1)
    axes[2].set_title("Speedup vs size")
    axes[2].set_xlabel("n")
    axes[2].legend()

    fig.tight_layout()
    fig.savefig(out / "comprehensive_benchmark.png", dpi=120)
    plt.close(fig)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)

    import scipy.optimize

    from ..bench.harness import time_rigorous
    from ..data.generators import FAMILIES
    from ..pipeline import WarmStartPipeline
    from ..train.checkpoint import build_model_from_meta, load_checkpoint
    from ..utils.profiling import profile_pipeline

    params, meta, _ = load_checkpoint(args.checkpoint)
    model = build_model_from_meta(meta)
    pipe = WarmStartPipeline(
        model, params, mode=args.mode,
        use_cost_refinement=bool(meta.get("use_cost_refinement", True)),
        seed_mode=args.seed_mode,
        route="device",  # measure the requested mode, not the router
        device=args.device,
    )

    rng = np.random.default_rng(0)
    rows = []
    for fam in args.families:
        for n in args.sizes:
            for k in range(args.instances):
                C = FAMILIES[fam](n, rng)
                s_scipy = time_rigorous(
                    lambda: scipy.optimize.linear_sum_assignment(C), 1, args.repeats
                )
                # the float32 cast outside the timed call: a host copy per
                # repeat would be charged to pipeline_ms
                C32 = np.asarray(C, np.float32)
                s_pipe = time_rigorous(lambda: pipe.solve(C32), 1, args.repeats)
                if not (s_scipy["success"] and s_pipe["success"]):
                    print(
                        f"# {fam} n={n} #{k}: measurement failed "
                        f"(scipy={s_scipy.get('error')}, "
                        f"pipe={s_pipe.get('error')}), skipping"
                    )
                    continue
                r, c = s_scipy["result"]  # the timed solve's result
                opt = float(C[r, c].sum())
                got = float(s_pipe["result"]["cost"][0])
                stages = profile_pipeline(pipe, C, repeats=2)
                row = {
                    "family": fam,
                    "n": n,
                    "instance": k,
                    "scipy_ms": s_scipy["median"] * 1e3,
                    "pipeline_ms": s_pipe["median"] * 1e3,
                    "gnn_ms": stages["gnn_overhead_ms"],
                    "solve_ms": stages["seeded_solve"],
                    "speedup_vs_scipy": s_scipy["median"] / s_pipe["median"],
                    "primal_gap_pct": 100.0 * (got - opt) / max(1e-12, abs(opt)),
                }
                rows.append(row)
                print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                                  for k, v in row.items()}))

    summary = {}
    if rows:
        with (args.out / "results.csv").open("w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        if not args.no_plots:
            _plots(rows, args.out)
        sp = [r["speedup_vs_scipy"] for r in rows]
        summary = {
            "mean_speedup": float(np.mean(sp)),
            "median_speedup": float(np.median(sp)),
            "max_primal_gap_pct": max(r["primal_gap_pct"] for r in rows),
        }
        print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
