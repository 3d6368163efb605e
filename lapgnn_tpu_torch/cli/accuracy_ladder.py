"""OneGNN-against-DualGNN accuracy ladder, per family and overall.

Port of ``lapgnn_tpu/cli/accuracy_ladder.py``, with ``--device`` (default
``cuda``; ``cpu`` runs on the CPU).  For each model on the same instances,
grouped by cost family: u / v MAE (also gauge-corrected), dual feasibility,
pre-solve greedy gap (raw and sentinel-clipped, with IQRs), assist rate and
fallback rate.  OneGNN is served by ``WarmStartPipeline(mode="hybrid")``,
DualGNN by ``evaluation.DualGNNPredictor``, both in the same ``--seed-mode``.

Example:
  python -m lapgnn_tpu_torch.cli.accuracy_ladder \
      --one-gnn artifacts/one_gnn_default --dual-gnn artifacts/dual_gnn_r5 \
      --split data/mixed_512/val.h5 --limit 40 --output logs/accuracy_ladder.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

LADDER_KEYS = ("u_mae", "u_mae_gauge", "v_mae", "feasible_rate", "assist_rate",
               "fallback_rate", "presolve_gap_median", "presolve_gap_clipped_median")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--one-gnn", type=Path, required=True)
    p.add_argument("--dual-gnn", type=Path, default=None)
    p.add_argument("--split", type=Path, nargs="+", required=True)
    p.add_argument("--limit", type=int, default=40)
    p.add_argument("--per-family", action="store_true", default=True)
    p.add_argument(
        "--seed-mode", choices=["auto", "gnn", "rank1"], default="auto",
        help="dual-seed source for BOTH models' serving posture: GNN, "
             "rank-1 analytic, or per-instance best (ops/rank1.py)",
    )
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def group_by_family(instances: Sequence[dict], limit: int) -> Dict[str, List[dict]]:
    """The first ``limit * 8`` instances grouped by their ``family``, at most
    ``limit`` a family."""
    by_family: Dict[str, List[dict]] = {}
    for inst in list(instances)[: limit * 8]:
        by_family.setdefault(str(inst.get("family", "unknown")), []).append(inst)
    return {fam: insts[:limit] for fam, insts in by_family.items()}


def ladder(models: Dict[str, object], by_family: Dict[str, List[dict]]) -> dict:
    """``evaluate_pipeline`` (no solver timing) of every model on every
    family, printed a line per (model, family) and per model overall.
    Returns ``{model: {"overall": {...}, "per_family": {family: metrics}}}``."""
    from ..evaluation import evaluate_pipeline

    out = {}
    for name, pipe in models.items():
        out[name] = {"overall": {}, "per_family": {}}
        agg = []
        for fam, insts in sorted(by_family.items()):
            m = evaluate_pipeline(pipe, insts, time_solvers=False)
            out[name]["per_family"][fam] = m
            agg.append(m)
            iqr = m["presolve_gap_clipped_iqr"]
            print(
                f"{name} {fam}: u_mae_gauge={m['u_mae_gauge']:.5f} "
                f"presolve_gap_med={m['presolve_gap_median']:.4f} "
                f"clipped_gap_med={m['presolve_gap_clipped_median']:.4f} "
                f"IQR=[{iqr[0]:.3f},{iqr[1]:.3f}] "
                f"assist={m['assist_rate']:.2f} fallback={m['fallback_rate']:.2f}"
            )
        out[name]["overall"] = {k: float(np.mean([m[k] for m in agg])) for k in LADDER_KEYS}
        print(f"{name} overall: {json.dumps(out[name]['overall'])}")
    return out


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from ..data.h5io import H5Reader
    from .eval import build_predictor

    instances = []
    for split in args.split:
        with H5Reader(split) as r:
            instances.extend(r[i] for i in range(len(r)))
    by_family = group_by_family(instances, args.limit)

    models = {"one_gnn": build_predictor(args.one_gnn, args.seed_mode, args.device)}
    if args.dual_gnn:
        models["dual_gnn"] = build_predictor(args.dual_gnn, args.seed_mode, args.device)

    result = ladder(models, by_family)
    line = json.dumps(result, indent=2)
    if args.output:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
