"""Warm-start pipeline: C -> features -> OneGNN -> seed policy -> exact solve.

Port of ``lapgnn_tpu/pipeline.py``.  Both modes share the dual prediction on
the GPU (row features through kernel K3, which runs K1; the seed policy's
min-trick projections through K2):

  * ``device`` (the default, as in the JAX class): the seeded
    Jonker–Volgenant solve runs on the GPU in float32
    (``solver.seeded.lapjv_seeded_single``, whose ARR bid is kernel K4),
    instance by instance; one packed float32 buffer ``[cost, used_fallback,
    col_of_row, v]`` comes back to the host in one copy, and ``certify=True``
    holds each result to the float64 certificate against the caller's
    matrix, repairing the duals or polishing on the host where it fails.
  * ``hybrid``: ``(u, v)`` come back in one stacked copy and the native
    seeded solver solves exactly in float64 on the host (the original
    system's own GPU posture: GPU predict, then a C++ solve).

Not ported yet (each raises ``NotImplementedError``): the lossy transfer
encodings and ``solve_stream``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .device import resolve_device
from .models import OneGNN
from .ops.dual import fast_min_trick, robust_normalize
from .ops.features import fast_row_features
from .ops.rank1 import rank1_duals
from .ops.sinkhorn import auto_select_seed
from .solver.jv import SolveStats
from .solver.seeded import lapjv_seeded_single
from .train.convert import params_from_flax

__all__ = ["WarmStartPipeline", "predict_duals_fn"]

_TRANSFER_SLICE = (
    "lossy transfer encodings and solve_stream are the next slice of the port "
    "and are not ported yet; use transfer_dtype='float32'"
)


def predict_duals_fn(
    model: OneGNN,
    use_cost_refinement: bool = True,
    normalize_costs: bool = False,
    seed_mode: str = "auto",
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Build ``predict(cost) -> (u, v)`` for a (B, n, n) float32 batch on
    the model's device.  The pair is always dual-feasible.

    As in the JAX version: ``normalize_costs`` feeds the model the
    sentinel-robust [0, 1] image of each instance and maps the duals back;
    ``seed_mode`` 'gnn' serves the model's seed, 'rank1' the closed-form
    rank-1 seed, and 'auto' selects among the model seed, the rank-1 seed and
    the Sinkhorn-refined winner (``ops.sinkhorn.auto_select_seed``).  The
    model's weights live in the module, so ``predict`` takes no parameters."""
    if seed_mode not in ("gnn", "rank1", "auto"):
        raise ValueError("seed_mode must be 'gnn', 'rank1', or 'auto'")

    @torch.inference_mode()
    def predict(cost: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if seed_mode == "rank1":
            u, _ = rank1_duals(cost)
            return u, fast_min_trick(cost, u)
        if normalize_costs:
            cost_in, mn, a = robust_normalize(cost)
        else:
            cost_in = cost
        feats = fast_row_features(cost_in)
        u = model(feats, cost=cost_in if use_cost_refinement else None)["u"]
        u = u.to(cost.dtype)
        if normalize_costs:
            u = u * a[..., None] + mn[..., None]
        if seed_mode == "auto":
            return auto_select_seed(cost, u)
        return u, fast_min_trick(cost, u)

    return predict


class WarmStartPipeline:
    """Batched GNN-seeded LAP solving.

    Args follow the JAX class, plus ``device``: the GPU by default (raises
    without one); pass ``device="cpu"`` to run on the CPU.  ``params`` is
    the flax parameter tree that ``train.checkpoint.load_checkpoint`` returns;
    it is loaded into ``model``, which moves to ``device``.
    """

    def __init__(
        self,
        model: OneGNN,
        params,
        mode: str = "device",
        eps: float = 1e-12,
        use_cost_refinement: bool = True,
        gate: str = "both",
        normalize_costs: bool = True,
        certify_tol: float = 1e-6,
        seed_mode: str = "auto",
        transfer_dtype: str = "float32",
        transfer_topk: int = 64,
        route: str = "auto",
        route_device_min_n: int = 1200,
        route_native_max_n: int = 384,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if mode not in ("device", "hybrid"):
            raise ValueError("mode must be 'device' or 'hybrid'")
        if transfer_dtype not in ("float32", "bfloat16", "float16", "uint16", "topk16"):
            raise ValueError(
                "transfer_dtype must be 'float32', 'bfloat16', 'float16', "
                "'uint16', or 'topk16'"
            )
        if route not in ("auto", "device", "host"):
            raise ValueError("route must be 'auto', 'device', or 'host'")
        if gate not in ("density", "free_rows", "both", "never"):
            raise ValueError("gate must be 'density', 'free_rows', 'both', or 'never'")
        if transfer_dtype != "float32":
            raise NotImplementedError(_TRANSFER_SLICE)
        self.device = resolve_device(device)
        self.mode = mode
        self.eps = eps
        self.gate = gate
        self.certify_tol = certify_tol
        self.seed_mode = seed_mode
        self.transfer_dtype = transfer_dtype
        self.transfer_topk = transfer_topk
        self.route = route
        self.route_device_min_n = route_device_min_n
        self.route_native_max_n = route_native_max_n
        # Loop counts of each instance of the last device-mode solve.
        self.last_solve_stats: List[SolveStats] = []
        model.load_state_dict(params_from_flax(params))
        self.model = model.to(self.device).eval()
        self._predict = predict_duals_fn(
            self.model, use_cost_refinement, normalize_costs, seed_mode
        )

    def _to_device(self, cost) -> torch.Tensor:
        """A host array or a tensor -> a (B, n, m) float32 batch on the
        pipeline's device (tensors already there are cast there)."""
        if isinstance(cost, torch.Tensor):
            t = cost.to(self.device, torch.float32)
        else:
            t = torch.from_numpy(np.ascontiguousarray(cost, np.float32)).to(self.device)
        return (t if t.ndim == 3 else t[None]).contiguous()

    def predict_duals(self, cost) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, n, n) -> ((B, n) u, (B, n) v) on the device, dual-feasible."""
        return self._predict(self._to_device(cost))

    def solve(self, cost, certify: bool = False) -> Dict[str, np.ndarray]:
        """Solve a batch.  Returns a dict with col_of_row, cost and
        used_fallback; with ``certify`` also certified, gap_bound, repaired,
        polished and polish_ms.

        In device mode ``certify`` evaluates the float64 dual certificate of
        each float32 device result against ``cost`` on the host, repairs the
        duals or polishes the assignment where it fails (as in the JAX
        version); certified entries take the float64 cost of their
        assignment.  Hybrid solves are float64-exact, so their certificate
        fields are trivially satisfied."""
        on_card = isinstance(cost, torch.Tensor) and cost.device.type == "cuda"
        if not on_card and self._route_to_host(np.shape(cost)[-1]):
            return self._solve_host_route(_host_f64(cost), certify)
        if self.mode == "device":
            cost_t = self._to_device(cost)
            n = cost_t.shape[-1]
            if cost_t.shape[-2] != n:
                raise ValueError(f"device mode solves square instances, got {tuple(cost_t.shape)}")
            packed = self._solve_device(cost_t)
            out = self._unpack(packed, n)
            if certify:
                self._certify_and_polish(_host_f64(cost), packed, out)
            return out
        out = self._solve_hybrid(cost)
        if certify:
            _add_trivial_certificate(out)
        return out

    def _route_to_host(self, n: int) -> bool:
        """Whether a batch of size n that lies on the host solves on the host.
        ``route="host"`` always; ``"auto"`` in device mode below
        ``route_device_min_n``, and only when the pipeline's device is a GPU
        (on the CPU the device is the host: there is no transfer to save).
        A CUDA tensor is never routed."""
        if self.route == "host":
            return True
        if self.route != "auto" or self.mode != "device":
            return False
        return n < self.route_device_min_n and self.device.type == "cuda"

    def solve_stream(self, costs, certify: bool = False, microbatch: int = 1) -> list:
        raise NotImplementedError(_TRANSFER_SLICE)

    def _solve_host_route(self, cost64: np.ndarray, certify: bool) -> Dict[str, np.ndarray]:
        """Host route: cold native JV up to ``route_native_max_n``, SciPy
        above it; float64 end to end."""
        import scipy.optimize

        from .solver.native import lapjv_native

        B, n, _ = cost64.shape
        xs, cs = [], []
        for b in range(B):
            if n <= self.route_native_max_n:
                x, _, c = lapjv_native(cost64[b])
            else:
                _, x = scipy.optimize.linear_sum_assignment(cost64[b])
                c = float(cost64[b][np.arange(n), x].sum())
            xs.append(np.asarray(x, np.int64))
            cs.append(float(c))
        out = {
            "col_of_row": np.stack(xs),
            "cost": np.asarray(cs),
            "used_fallback": np.zeros(B, bool),
            "routed_host": np.ones(B, bool),
        }
        if certify:
            _add_trivial_certificate(out)
        return out

    def _solve_device(self, cost_t: torch.Tensor) -> np.ndarray:
        """Predict, then the seeded float32 solve instance by instance on the
        device (as the JAX serving program's ``lax.scan``), then one packed
        (B, 2 + 2n) float32 buffer ``[cost, used_fallback, col_of_row, v]``
        copied to the host once (pipeline.py:440-489 of the JAX version)."""
        u, v = self._predict(cost_t)
        self.last_solve_stats = []
        rows = []
        with torch.inference_mode():
            for b in range(cost_t.shape[0]):
                stats = SolveStats()
                res = lapjv_seeded_single(
                    cost_t[b], u[b], v[b], eps=self.eps, gate=self.gate, stats=stats
                )
                self.last_solve_stats.append(stats)
                rows.append(torch.cat([
                    res.cost[None].to(torch.float32),
                    res.used_fallback[None].to(torch.float32),
                    res.col_of_row.to(torch.float32),
                    res.v.to(torch.float32),
                ]))
            return torch.stack(rows).cpu().numpy()

    @staticmethod
    def _unpack(packed: np.ndarray, n: int) -> Dict[str, np.ndarray]:
        return {
            "col_of_row": packed[:, 2 : 2 + n].astype(np.int64),
            "cost": packed[:, 0].astype(np.float64),
            "used_fallback": packed[:, 1] > 0.5,
        }

    def _certify_and_polish(
        self, cost_np: np.ndarray, packed: np.ndarray, out: Dict[str, np.ndarray]
    ) -> None:
        """Float64 exactness pass against the true cost matrix, in place
        (pipeline.py:656 of the JAX version).  Cheapest sufficient proof
        first:
          1. the raw certificate with the device duals as they are;
          2. the native dual repair (``repair_duals_native``), which succeeds
             iff the device assignment is exactly optimal for the true
             matrix;
          3. the native float64 solve warm-started from the device duals, and
             the cold native solve if that fails its own certificate or the
             device result is unusable (NaN duals, not a permutation).
        Certified entries take the f64 cost of their assignment.  Adds
        'certified', 'gap_bound', 'repaired', 'polished', 'polish_ms'."""
        from .solver.native import (
            NativeSolveError,
            lapjv_native,
            lapjv_seeded_native,
            repair_duals_native,
        )
        from .solver.verification import certify_assignment

        B, n = packed.shape[0], cost_np.shape[-1]
        v_all = packed[:, 2 + n :].astype(np.float64)
        certified = np.zeros(B, bool)
        gap_bound = np.zeros(B)
        repaired = np.zeros(B, bool)
        polished = np.zeros(B, bool)
        polish_ms = np.zeros(B)
        for b in range(B):
            x_b = out["col_of_row"][b]
            usable = (
                np.array_equal(np.sort(x_b), np.arange(n)) and np.isfinite(v_all[b]).all()
            )
            ok, _, bound = certify_assignment(cost_np[b], x_b, v_all[b], tol=self.certify_tol)
            if not ok and usable:
                try:
                    rep = repair_duals_native(cost_np[b], x_b, v_all[b])
                except NativeSolveError:
                    rep = None  # no toolchain: the polish below decides
                if rep is not None and np.isfinite(rep[1]):
                    viol = max(0.0, -rep[1])
                    ok = viol <= self.certify_tol
                    bound = n * viol
                    repaired[b] = ok
            certified[b], gap_bound[b] = ok, bound
            if ok:
                out["cost"][b] = float(cost_np[b][np.arange(n), x_b].sum())
                continue
            t0 = time.perf_counter()
            if usable:
                u_b = cost_np[b][np.arange(n), x_b] - v_all[b][x_b]
                x, _, c, info = lapjv_seeded_native(
                    cost_np[b], u_b, v_all[b], eps=self.eps, gate=self.gate,
                    return_info=True,
                )
                v_fin = info["v"]
            else:
                x, _, c, _, v_fin = lapjv_native(cost_np[b], return_duals=True)
            ok2, _, bound2 = certify_assignment(cost_np[b], x, v_fin, tol=self.certify_tol)
            if not ok2 and usable:
                x, _, c, _, v_fin = lapjv_native(cost_np[b], return_duals=True)
                ok2, _, bound2 = certify_assignment(cost_np[b], x, v_fin, tol=self.certify_tol)
            out["col_of_row"][b] = x
            out["cost"][b] = c
            certified[b], gap_bound[b] = ok2, bound2
            polished[b] = True
            polish_ms[b] = (time.perf_counter() - t0) * 1e3
        out["certified"] = certified
        out["gap_bound"] = gap_bound
        out["repaired"] = repaired
        out["polished"] = polished
        out["polish_ms"] = polish_ms

    def _solve_hybrid(self, cost) -> Dict[str, np.ndarray]:
        """GPU predict, one stacked (B, 2, n) device-to-host copy of (u, v),
        then the float64 native seeded solve per instance."""
        from .solver.native import lapjv_seeded_native

        u, v = self._predict(self._to_device(cost))
        packed_uv = torch.stack([u, v], dim=1).cpu().numpy()
        u_np = packed_uv[:, 0, :].astype(np.float64)
        v_np = packed_uv[:, 1, :].astype(np.float64)
        cost_np = _host_f64(cost)
        xs, costs, fbs = [], [], []
        for b in range(cost_np.shape[0]):
            x, _, c, info = lapjv_seeded_native(
                cost_np[b], u_np[b], v_np[b], eps=self.eps, return_info=True,
                gate=self.gate,
            )
            xs.append(x)
            costs.append(c)
            fbs.append(info["used_fallback"])
        return {
            "col_of_row": np.stack(xs),
            "cost": np.asarray(costs),
            "used_fallback": np.asarray(fbs),
        }


def _host_f64(cost) -> np.ndarray:
    if isinstance(cost, torch.Tensor):
        cost = cost.detach().cpu().numpy()
    c = np.asarray(cost, np.float64)
    return c if c.ndim == 3 else c[None]


def _add_trivial_certificate(out: Dict[str, np.ndarray]) -> None:
    B = len(out["cost"])
    out["certified"] = np.ones(B, bool)
    out["gap_bound"] = np.zeros(B)
    out["repaired"] = np.zeros(B, bool)
    out["polished"] = np.zeros(B, bool)
    out["polish_ms"] = np.zeros(B)
