"""Pipeline stage profiler (port of ``lapgnn_tpu/utils/profiling.py``).

``profile_pipeline`` brackets each named stage of the warm-start pipeline
with a barrier and aggregates per-stage milliseconds, the GNN overhead and
the total pipeline time, under the JAX version's stage names.  The barrier
is ``torch.cuda.synchronize`` on each GPU that holds a tensor of the stage's
output (the JAX version reads back one scalar instead).

``trace`` records a ``torch.profiler`` trace of the block and writes it as a
Chrome trace (``trace.json``; open it in Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from .. import tracing
from ..bench.harness import synchronize_block
from ..solver.seeded import lapjv_seeded_batch

__all__ = ["StageProfiler", "profile_pipeline", "trace"]


class StageProfiler:
    """Collects named stage timings over repeated runs.  A stage that puts
    its output in ``box["out"]`` is timed until the GPUs holding it are
    done."""

    def __init__(self):
        self.stages: Dict[str, list] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        box: Dict[str, object] = {}
        try:
            yield box
        finally:
            if "out" in box:
                synchronize_block(box["out"])
            self.stages.setdefault(name, []).append(time.perf_counter() - t0)

    def summary_ms(self) -> Dict[str, float]:
        return {k: float(np.median(v) * 1e3) for k, v in self.stages.items()}


def profile_pipeline(pipe, C: np.ndarray, repeats: int = 5) -> Dict[str, float]:
    """Per-stage breakdown of one warm-start solve on ``pipe.device``.

    Stages: data_to_device, normalize, feature_compute (K3 with K1 on a
    GPU), gnn_inference, v_compute (the rank-1 seed and ``select_best_seed``
    under seed_mode 'auto', both min-tricks through K2; else the min-trick
    alone), seeded_solve (``lapjv_seeded_batch`` with the pipeline's eps and
    gate, the device solver that ``solve`` runs, in device mode; the native
    float64 seeded solve in hybrid mode),
    validation; plus the aggregates gnn_overhead_ms and total_pipeline_ms.
    The first of ``repeats + 1`` runs warms every stage up and is dropped.
    """
    from ..ops.dual import fast_min_trick, robust_normalize
    from ..ops.features import fast_row_features
    from ..ops.rank1 import rank1_duals, select_best_seed

    model = pipe.model
    seed_mode = getattr(pipe, "seed_mode", "auto")
    normalize = seed_mode != "rank1"
    use_cost = True

    def seed_select(c, u):
        u_r1, _ = rank1_duals(c)
        return select_best_seed(c, (u, u_r1))

    prof = StageProfiler()
    C = np.asarray(C, np.float32)
    if C.ndim == 2:
        C = C[None]

    with torch.inference_mode():
        for _ in range(repeats + 1):
            with prof.stage("data_to_device") as box:
                Cd = torch.from_numpy(C).to(pipe.device)
                box["out"] = Cd
            with prof.stage("normalize") as box:
                if normalize:
                    C_in, mn, a = robust_normalize(Cd)
                else:
                    C_in, mn, a = Cd, None, None
                box["out"] = C_in
            with prof.stage("feature_compute") as box:
                feats = fast_row_features(C_in)
                box["out"] = feats
            with prof.stage("gnn_inference") as box:
                preds = model(feats, cost=C_in if use_cost else None)
                box["out"] = preds
            u = preds["u"].to(Cd.dtype)
            if normalize:
                u = u * a[..., None] + mn[..., None]
            with prof.stage("v_compute") as box:
                if seed_mode == "auto":
                    u, v = seed_select(Cd, u)
                else:
                    v = fast_min_trick(Cd, u)
                box["out"] = v
            with prof.stage("seeded_solve") as box:
                if pipe.mode == "device":
                    res = lapjv_seeded_batch(Cd, u, v, eps=pipe.eps, gate=pipe.gate)
                    box["out"] = res.cost
                    x = res.col_of_row.cpu().numpy()
                else:
                    from ..solver.native import lapjv_seeded_native

                    u_np = u.cpu().numpy().astype(np.float64)
                    v_np = v.cpu().numpy().astype(np.float64)
                    x = np.stack([
                        lapjv_seeded_native(np.asarray(C[b], np.float64), u_np[b], v_np[b])[0]
                        for b in range(C.shape[0])
                    ])
            with prof.stage("validation"):
                for b in range(C.shape[0]):
                    if sorted(x[b].tolist()) != list(range(C.shape[-1])):
                        raise AssertionError(f"instance {b}: the solve is not a permutation")

    # drop the warm-up sample of each stage
    for k in prof.stages:
        prof.stages[k] = prof.stages[k][1:]

    out = prof.summary_ms()
    out["gnn_overhead_ms"] = (
        out.get("normalize", 0.0)
        + out.get("feature_compute", 0.0)
        + out.get("gnn_inference", 0.0)
        + out.get("v_compute", 0.0)
    )
    out["total_pipeline_ms"] = sum(v for k, v in out.items() if not k.endswith("_ms"))
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[Union[str, Path]] = None):
    """``torch.profiler`` over the block (CPU, and CUDA where there is a GPU),
    written to ``log_dir/trace.json`` as a Chrome trace when the block ends.
    ``log_dir`` defaults to ``lapgnn_trace`` in the temporary directory.
    The program's spans (``tracing``) appear in the Chrome trace; the tracer
    drops the ones it recorded here, unless a ``tracing.record()`` block
    holds the call."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir) if log_dir is not None else Path(tempfile.gettempdir()) / "lapgnn_trace"
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    first = tracing.mark()
    try:
        with profile(activities=activities) as prof:
            yield log_dir
        prof.export_chrome_trace(str(log_dir / "trace.json"))
    finally:
        if not tracing.enabled():
            tracing.discard(first)
