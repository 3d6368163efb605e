"""Model evaluation CLI: score one checkpoint on an HDF5 split.

Port of ``lapgnn_tpu/cli/eval.py``, with ``--device`` (default ``cuda``;
``cpu`` runs on the CPU).  A DualGNN checkpoint is served by
``evaluation.DualGNNPredictor``, a OneGNN one by ``WarmStartPipeline``.

Example:
  python -m lapgnn_tpu_torch.cli.eval --checkpoint artifacts/one_gnn_default \
      --split data/mid512/val.h5 --limit 50
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", type=Path, required=True)
    p.add_argument("--split", type=Path, required=True)
    p.add_argument("--limit", type=int, default=50)
    p.add_argument("--mode", choices=["device", "hybrid"], default="hybrid")
    p.add_argument(
        "--seed-mode", choices=["auto", "gnn", "rank1"], default="auto",
        help="dual-seed source: GNN, rank-1 analytic, or per-instance best (ops/rank1.py)",
    )
    p.add_argument("--no-timing", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def build_predictor(checkpoint: Path, seed_mode: str, device, mode: str = "hybrid"):
    """The checkpoint as something with ``predict_duals``: a
    ``DualGNNPredictor`` for a DualGNN, else a ``WarmStartPipeline``."""
    from ..evaluation import DualGNNPredictor
    from ..pipeline import WarmStartPipeline
    from ..train.checkpoint import build_model_from_meta, load_checkpoint

    params, meta, _ = load_checkpoint(checkpoint)
    model = build_model_from_meta(meta)
    if meta.get("architecture") == "dual_gnn":
        return DualGNNPredictor(model, params, seed_mode=seed_mode, device=device)
    return WarmStartPipeline(
        model, params, mode=mode,
        use_cost_refinement=bool(meta.get("use_cost_refinement", True)),
        seed_mode=seed_mode, device=device,
    )


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from ..data.h5io import H5Reader
    from ..evaluation import evaluate_pipeline

    pipe = build_predictor(args.checkpoint, args.seed_mode, args.device, args.mode)
    with H5Reader(args.split) as r:
        instances = [r[i] for i in range(min(len(r), args.limit))]
    metrics = evaluate_pipeline(pipe, instances, time_solvers=not args.no_timing)
    print(json.dumps(metrics, indent=2))


if __name__ == "__main__":
    main()
