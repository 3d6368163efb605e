"""Model evaluation: dual quality, assist rate and solver speedup metrics.

Port of ``lapgnn_tpu/evaluation.py`` (``DualGNNPredictor`` :29,
``evaluate_pipeline`` :80).  Per instance:
  * predict (u, v) with the pipeline or predictor (the min-trick makes the
    pair feasible),
  * the dual feasibility check and u / v MSE and MAE against the oracle
    duals,
  * the pre-solve greedy primal gap (the greedy kernel on a CUDA device),
    raw and with the sparse family's sentinels clipped,
  * optionally the wall clock of the cold native JV against the seeded
    native JV from the predicted duals, and the assist rate: the share of
    instances whose seeded cost equals the optimum to 1e-6 relative (1.0 by
    construction, since the seeded solver is exact).

The JAX function computes the greedy bound and the feasibility check on
``jnp.asarray`` of float64 matrices, which is float32 under the package's
default (x64 off); the port computes both in float32, on the predictor's
device.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from .device import resolve_device
from .ops.dual import check_dual_feasible
from .ops.rank1 import rank1_duals
from .pipeline import device_batch, predict_duals_fn
from .train.convert import params_from_flax
from .train.loss import BIG, greedy_primal_upper

__all__ = ["DualGNNPredictor", "evaluate_pipeline"]


class DualGNNPredictor:
    """``predict_duals`` for DualGNN, so that ``evaluate_pipeline`` scores
    both models by the same code: u from the model, v from the min-trick
    (v_hint is a training aid, not the serving column dual).

    The predict is the serving pipeline's own (``pipeline.predict_duals_fn``
    of a DualGNN, which ``WarmStartPipeline`` runs): this class only loads
    the weights and moves the cost to the device.  ``params`` is the flax
    tree ``train.checkpoint.load_checkpoint`` returns or the model's own
    state dict.  ``seed_mode`` as the OneGNN pipeline's: 'gnn' serves the
    model's u, 'rank1' the rank-1 analytic duals, 'auto' (the default) the
    shared policy ``ops.sinkhorn.auto_select_seed``.  ``device`` is the GPU
    by default (raises without one)."""

    def __init__(
        self,
        model,
        params,
        seed_mode: str = "auto",
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.seed_mode = seed_mode
        self.device = resolve_device(device)
        state = params
        if not all(isinstance(t, torch.Tensor) for t in params.values()):
            state = params_from_flax(params)
        model.load_state_dict(state)
        self.model = model.to(self.device).eval()
        self._predict = predict_duals_fn(self.model, seed_mode=seed_mode)

    def predict_duals(self, cost):
        """(B, n, n) -> ((B, n) u, (B, n) v) on the device, dual-feasible."""
        return self._predict(device_batch(cost, self.device))


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _greedy_bound(C: np.ndarray, u: np.ndarray, v: np.ndarray, device) -> float:
    """The greedy primal bound of the float32 image of C under the float32
    image of its float64 reduced costs."""
    red = C - u[:, None] - v[None, :]
    f32 = [torch.from_numpy(a.astype(np.float32))[None].to(device) for a in (C, red)]
    return float(greedy_primal_upper(*f32)[0])


def evaluate_pipeline(
    pipe,
    instances: Sequence[Dict[str, np.ndarray]],
    time_solvers: bool = True,
    repeats: int = 3,
) -> Dict[str, float]:
    """Evaluate over instance dicts with keys cost / u / v / opt_cost.
    ``pipe`` has ``predict_duals`` (a ``WarmStartPipeline`` or a
    ``DualGNNPredictor``); the work runs on its ``device`` (the GPU for an
    object without one, as ``resolve_device`` picks).  Returns the JAX
    function's keys."""
    from .solver.native import lapjv_native, lapjv_seeded_native

    device = resolve_device(getattr(pipe, "device", None))
    feasible = []
    u_mse, v_mse, u_mae, v_mae = [], [], [], []
    u_mae_gauge = []
    presolve_gap = []
    presolve_gap_clipped = []
    speedups = []
    assists = []
    fallbacks = []
    rank1_wins = []

    for inst in instances:
        C = np.asarray(inst["cost"], np.float64)
        Cd = torch.from_numpy(C.astype(np.float32))[None].to(device)
        u_pred, v_pred = pipe.predict_duals(Cd)
        u_np = _host64(u_pred[0])
        v_np = _host64(v_pred[0])

        u32, v32 = (torch.from_numpy(a.astype(np.float32)).to(device) for a in (u_np, v_np))
        feasible.append(bool(check_dual_feasible(Cd[0], u32, v32, tol=1e-5)))
        u_star, v_star = np.asarray(inst["u"]), np.asarray(inst["v"])
        u_mse.append(float(np.mean((u_np - u_star) ** 2)))
        v_mse.append(float(np.mean((v_np - v_star) ** 2)))
        u_mae.append(float(np.mean(np.abs(u_np - u_star))))
        v_mae.append(float(np.mean(np.abs(v_np - v_star))))
        # gauge-corrected: duals are defined up to a shift (u + c, v - c)
        du = u_np - u_star
        u_mae_gauge.append(float(np.mean(np.abs(du - du.mean()))))

        if getattr(pipe, "seed_mode", "gnn") == "auto":
            # the served u equals the rank-1 duals exactly when they won the
            # selection; the tolerance absorbs reduction-order differences of
            # this recomputation (rank-1 duals grow like n on noisy_linear)
            u_r1 = _host64(rank1_duals(Cd)[0][0])
            tol = 1e-4 * (1.0 + float(np.abs(u_r1).max()))
            rank1_wins.append(bool(np.allclose(u_np, u_r1, atol=tol)))

        ub = _greedy_bound(C, u_np, v_np, device)
        opt = float(inst.get("opt_cost", ub))
        presolve_gap.append(ub - opt)
        # Sentinel-clipped twin: on the sparse family one forbidden-edge
        # collision adds ~1e6 to the raw bound.  Clipping the sentinels to
        # the largest real cost (float64, threshold 0.5 * BIG, as
        # clip_cost_sentinels) leaves the optimum unchanged; on a
        # sentinel-free family the clipped gap is the raw gap.
        finite = C < 0.5 * BIG
        if finite.all():
            presolve_gap_clipped.append(presolve_gap[-1])
        else:
            fmax = C[finite].max() if finite.any() else np.inf
            C_clip = np.minimum(C, fmax)
            presolve_gap_clipped.append(_greedy_bound(C_clip, u_np, v_np, device) - opt)

        _, _, cost_seeded, info = lapjv_seeded_native(
            C, u_np, v_np, return_info=True, gate="both"
        )
        assists.append(abs(cost_seeded - opt) <= 1e-6 * max(1.0, abs(opt)))
        fallbacks.append(info["used_fallback"])

        if time_solvers:
            ts, tc = [], []
            for _ in range(repeats):
                t0 = time.perf_counter()
                lapjv_native(C)
                tc.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                lapjv_seeded_native(C, u_np, v_np, gate="both")
                ts.append(time.perf_counter() - t0)
            speedups.append(float(np.median(tc) / np.median(ts)))

    out = {
        "num_instances": len(instances),
        "feasible_rate": float(np.mean(feasible)),
        "assist_rate": float(np.mean(assists)),
        "fallback_rate": float(np.mean(fallbacks)),
        "u_mse": float(np.mean(u_mse)),
        "v_mse": float(np.mean(v_mse)),
        "u_mae": float(np.mean(u_mae)),
        "u_mae_gauge": float(np.mean(u_mae_gauge)),
        "v_mae": float(np.mean(v_mae)),
        "presolve_gap_mean": float(np.mean(presolve_gap)),
        "presolve_gap_median": float(np.median(presolve_gap)),
        "presolve_gap_clipped_mean": float(np.mean(presolve_gap_clipped)),
        "presolve_gap_clipped_median": float(np.median(presolve_gap_clipped)),
        # per-instance IQRs: a model-against-model delta smaller than these
        # is noise
        "presolve_gap_clipped_iqr": [
            float(np.percentile(presolve_gap_clipped, 25)),
            float(np.percentile(presolve_gap_clipped, 75)),
        ],
        "u_mae_gauge_iqr": [
            float(np.percentile(u_mae_gauge, 25)),
            float(np.percentile(u_mae_gauge, 75)),
        ],
    }
    if rank1_wins:
        out["rank1_seed_win_rate"] = float(np.mean(rank1_wins))
    if speedups:
        out["seeded_vs_cold_speedup_mean"] = float(np.mean(speedups))
        out["seeded_vs_cold_speedup_median"] = float(np.median(speedups))
    return out
