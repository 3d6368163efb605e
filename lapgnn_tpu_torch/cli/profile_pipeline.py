"""Stage-level pipeline profiler CLI.

Port of ``lapgnn_tpu/cli/profile_pipeline.py``, with ``--device`` (default
``cuda``; ``cpu`` runs on the CPU): per family, the per-stage timing
breakdown of ``utils.profiling.profile_pipeline`` (data_to_device,
normalize, feature_compute, gnn_inference, v_compute, seeded_solve,
validation) with a GNN-against-fallback recommendation.

Example:
  python -m lapgnn_tpu_torch.cli.profile_pipeline --checkpoint artifacts/one_gnn_default \
      --families uniform sparse --size 2048 --mode device
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", type=Path, required=True)
    p.add_argument("--families", nargs="+", default=["uniform"])
    p.add_argument("--size", type=int, default=2048)
    p.add_argument("--mode", choices=["device", "hybrid"], default="device")
    p.add_argument(
        "--seed-mode", choices=["auto", "gnn", "rank1"], default="auto",
        help="dual-seed source: GNN, rank-1 analytic, or per-instance best (ops/rank1.py)",
    )
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import scipy.optimize

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
        route="device",  # profile the device pipeline, not the router
        device=args.device,
    )

    rng = np.random.default_rng(0)
    out = {}
    for fam in args.families:
        C = FAMILIES[fam](args.size, rng)
        stages = profile_pipeline(pipe, C, repeats=args.repeats)
        # warm start pays off when the GNN overhead is small against the
        # solve it saves
        t0 = time.perf_counter()
        scipy.optimize.linear_sum_assignment(C)
        scipy_ms = (time.perf_counter() - t0) * 1e3
        stages["scipy_ms"] = scipy_ms
        stages["recommendation"] = (
            "gnn_warmstart" if stages["total_pipeline_ms"] < scipy_ms else "fallback"
        )
        out[fam] = {k: round(v, 3) if isinstance(v, float) else v for k, v in stages.items()}
        print(f"{fam}: {json.dumps(out[fam])}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
