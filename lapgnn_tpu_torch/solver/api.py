"""Solver classes with one interface, ``solve(C) -> (rows, cols, cost)``.

Port of ``lapgnn_tpu/solver/api.py``:

  SciPySolver        - scipy.optimize.linear_sum_assignment (the baseline)
  LAPSolver          - native C++ cold JV (lapx_dense)
  SeededLAPSolver    - native C++ warm-started JV (lapx_seeded)
  TorchSolver        - the port's device cold JV (``solver.jv.lapjv_batch``)
  SeededTorchSolver  - the port's device warm-started JV
                       (``solver.seeded.lapjv_seeded_batch``)
  LAPMODSolver       - the native sparse CSR solve of a dense matrix whose
                       forbidden edges are dropped
  WarmStartLAPSolver - reduced-cost warm start: cold-solve C' = C - u - v

``TorchSolver`` and ``SeededTorchSolver`` take the places of the JAX
package's ``JAXSolver`` and ``SeededJAXSolver`` (names "torch" and
"seeded_torch"); they run on the GPU unless given ``device="cpu"``, in
``dtype`` (float32 by default; on the GPU the ARR bid is kernel K4, in
float32 or float64).

All return 0-based (rows, cols, cost) with rows = arange(n).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.host_dual import reduce_costs_np

__all__ = [
    "SciPySolver",
    "LAPSolver",
    "SeededLAPSolver",
    "TorchSolver",
    "SeededTorchSolver",
    "LAPMODSolver",
    "WarmStartLAPSolver",
]

Result = Tuple[np.ndarray, np.ndarray, float]


class _Base:
    name = "base"

    def solve(self, C: np.ndarray) -> Result:  # pragma: no cover - interface
        raise NotImplementedError


class SciPySolver(_Base):
    """scipy.optimize.linear_sum_assignment."""

    name = "scipy"

    def solve(self, C: np.ndarray) -> Result:
        import scipy.optimize

        rows, cols = scipy.optimize.linear_sum_assignment(C)
        return rows, cols, float(C[rows, cols].sum())


class LAPSolver(_Base):
    """Native C++ cold JV."""

    name = "lap"

    def solve(self, C: np.ndarray) -> Result:
        from .native import lapjv_native

        x, _, cost = lapjv_native(C)
        n = C.shape[0]
        return np.arange(n), np.asarray(x, np.int64), cost


class SeededLAPSolver(_Base):
    """Native C++ warm-started JV."""

    name = "seeded_lap"

    def __init__(self, eps: float = 1e-12):
        self.eps = eps

    def solve(
        self, C: np.ndarray, u: Optional[np.ndarray] = None, v: Optional[np.ndarray] = None
    ) -> Result:
        from .native import lapjv_seeded_native

        n = C.shape[0]
        if u is None:
            u = np.zeros(n)
        if v is None:
            v = np.zeros(n)
        x, _, cost = lapjv_seeded_native(C, u, v, eps=self.eps)
        return np.arange(n), np.asarray(x, np.int64), cost


def _to_device(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)


class TorchSolver(_Base):
    """The port's device cold JV (``solver.jv.lapjv_batch``)."""

    name = "torch"

    def __init__(
        self,
        dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.dtype = dtype
        self.device = resolve_device(device)

    def solve(self, C: np.ndarray) -> Result:
        from .jv import lapjv_batch

        n = C.shape[0]
        x, _, cost = lapjv_batch(_to_device(C, self.dtype, self.device)[None])
        return np.arange(n), x[0].cpu().numpy().astype(np.int64), float(cost[0])


class SeededTorchSolver(_Base):
    """The port's device warm-started JV (``solver.seeded.lapjv_seeded_batch``)."""

    name = "seeded_torch"

    def __init__(
        self,
        eps: float = 1e-12,
        dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.eps = eps
        self.dtype = dtype
        self.device = resolve_device(device)

    def solve(
        self, C: np.ndarray, u: Optional[np.ndarray] = None, v: Optional[np.ndarray] = None
    ) -> Result:
        from .seeded import lapjv_seeded_batch

        n = C.shape[0]
        if u is None:
            u = np.zeros(n)
        if v is None:
            v = np.zeros(n)
        res = lapjv_seeded_batch(
            _to_device(C, self.dtype, self.device)[None],
            _to_device(u, self.dtype, self.device)[None],
            _to_device(v, self.dtype, self.device)[None],
            eps=self.eps,
        )
        return np.arange(n), res.col_of_row[0].cpu().numpy().astype(np.int64), float(res.cost[0])


class LAPMODSolver(_Base):
    """Sparse-instance solve on the CSR path.

    Drops the forbidden edges of a dense matrix (entries at or above
    ``forbidden_threshold``, or non-finite) and runs the native sparse solver
    (``lapx_sparse``).  When the allowed edges admit no perfect matching it
    answers with a dense solve in which each forbidden edge costs a sentinel
    above every allowed cost.  ``last_route`` says which answered the last
    call: "sparse" or "dense_fallback".
    """

    name = "lapmod"

    def __init__(
        self,
        forbidden_threshold: float = 1e6,
        sentinel: float = 1e6,
        fp_version: int = 3,
    ):
        self.forbidden_threshold = forbidden_threshold
        self.sentinel = sentinel
        self.fp_version = fp_version
        self.last_route: Optional[str] = None

    def solve(self, C: np.ndarray) -> Result:
        from .native import (
            NativeSolveError,
            lapjv_native,
            lapmod_native,
            sparse_from_dense,
        )

        C = np.asarray(C, dtype=np.float64)
        n = C.shape[0]
        row_ptr, col_idx, values = sparse_from_dense(C, self.forbidden_threshold)

        # The CSR path wants values below 1e6: rescale rather than reject (the
        # assignment is scale-invariant; the cost is reported in C's units).
        scale = 1.0
        if values.size:
            vmax = float(values.max())
            if vmax >= 1e6:
                scale = vmax / 1e5
                values = values / scale
        try:
            x, _, cost = lapmod_native(
                n, row_ptr, col_idx, values, fp_version=self.fp_version
            )
            cost *= scale
            self.last_route = "sparse"
        except NativeSolveError:
            # The sentinel must exceed every allowed finite cost: a fixed 1e6
            # would undercut instances whose costs are larger and make the
            # dense solve prefer forbidden edges.
            allowed = np.isfinite(C) & (C < self.forbidden_threshold)
            vmax_allowed = float(C[allowed].max()) if allowed.any() else 0.0
            sentinel = max(self.sentinel, 1e3 * max(1.0, abs(vmax_allowed)))
            Cm = np.where(allowed, C, sentinel)
            x, _, cost = lapjv_native(Cm)
            self.last_route = "dense_fallback"
        return np.arange(n), np.asarray(x, np.int64), cost


class WarmStartLAPSolver(_Base):
    """Reduced-cost warm start: solves the shifted non-negative reduced
    matrix C' = C - u - v with a cold solver (the same optimal assignment as
    C) and reports the cost on C."""

    name = "warmstart_reduced"

    def __init__(self, backend: str = "lap"):
        self.backend = backend

    def solve(
        self, C: np.ndarray, u: Optional[np.ndarray] = None, v: Optional[np.ndarray] = None
    ) -> Result:
        n = C.shape[0]
        if u is None:
            u = np.zeros(n)
        if v is None:
            v = np.zeros(n)
        Cp = reduce_costs_np(C, u, v, shift_nonneg=True)
        inner = LAPSolver() if self.backend == "lap" else SciPySolver()
        rows, cols, _ = inner.solve(Cp)
        return rows, cols, float(np.asarray(C)[rows, cols].sum())
