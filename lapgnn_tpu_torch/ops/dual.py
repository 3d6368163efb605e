"""Dual-potential math for the Linear Assignment Problem, batched in PyTorch.

Port of ``lapgnn_tpu/ops/dual.py``.  Convention, as there:

  C : (..., n, n) cost matrix
  u : (..., n)    row dual potentials
  v : (..., n)    column dual potentials

Feasibility means ``C[i, j] - u[i] - v[j] >= -tol`` for all (i, j).  The
two ``lax.while_loop``s of the JAX module (``project_feasible``,
``duals_from_matching``) are Python loops here that read their stop flag on
the host once a round.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .cuda.colmin import min_trick
from .partition import WHOLE, RowPartition

__all__ = [
    "BIG",
    "masked_fill",
    "reduced_costs",
    "min_trick_v",
    "fast_min_trick",
    "robust_normalize",
    "tighten_rows",
    "project_feasible",
    "dual_objective",
    "check_dual_feasible",
    "check_complementary_slackness",
    "duals_from_matching",
    "center_gauge",
]

# Large-but-safe sentinel for masked entries (lapgnn_tpu/ops/dual.py:54).
BIG = 1.0e6


def _mask2d(mask: torch.Tensor) -> torch.Tensor:
    return mask[..., :, None] & mask[..., None, :]


def masked_fill(
    C: torch.Tensor, mask: Optional[torch.Tensor], fill: float = BIG
) -> torch.Tensor:
    """Replace entries outside the valid (row x col) block with ``fill``."""
    if mask is None:
        return C
    return torch.where(_mask2d(mask), C, torch.tensor(fill, dtype=C.dtype, device=C.device))


def reduced_costs(C: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """r = C - u 1^T - 1 v^T."""
    return C - u[..., :, None] - v[..., None, :]


def min_trick_v(
    C: torch.Tensor, u: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Column duals via the min-trick: v_j = min_i (C_ij - u_i).

    For any u this yields a dual-feasible (u, v) pair.  This is the plain
    version of kernel K2 (``ops.cuda.colmin.min_trick``)."""
    red = C - u[..., :, None]
    if mask is not None:
        red = torch.where(_mask2d(mask), red, BIG)
    v = red.amin(-2)
    if mask is not None:
        v = torch.where(mask, v, 0.0)
    return v


def fast_min_trick(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``min_trick_v`` through kernel K2 on a CUDA tensor, at every n.

    The TPU router's gates (n >= 2048, TPU backend) were measured on a TPU
    and do not carry over; a CPU tensor takes the plain version inside the
    wrapper.  The unmasked form is the only one the predict path calls."""
    return min_trick(C.contiguous(), u.contiguous())


def robust_normalize(
    C: torch.Tensor, sentinel: float = 0.5e6, clip: float = 3.0, part: RowPartition = WHOLE
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-instance affine normalization robust to forbidden-edge sentinels.

    The scale comes from the sub-sentinel entries only; sentinel entries land
    above 1 and are clipped to ``clip``.  Returns (C_normalized, mn, a) with
    C = a*C' + mn exact on the sub-sentinel entries.  With a row partition
    ``part`` C holds its rows and the extremes are every row's."""
    is_real = C < sentinel
    # +/-inf fills, not +/-BIG: a -BIG fill could win the max when every real
    # entry is below -1e6 (see the JAX version).
    mn = part.min(torch.where(is_real, C, torch.inf).amin((-2, -1), keepdim=True))
    mx = part.max(torch.where(is_real, C, -torch.inf).amax((-2, -1), keepdim=True))
    any_real = part.max(is_real.flatten(-2).any(-1))[..., None, None]
    mn = torch.where(any_real, mn, part.min(C.amin((-2, -1), keepdim=True)))
    mx = torch.where(any_real, mx, part.max(C.amax((-2, -1), keepdim=True)))
    a = torch.clamp_min(mx - mn, 1e-12)
    C_n = torch.clamp_max((C - mn) / a, clip)
    return C_n, mn[..., 0, 0], a[..., 0, 0]


def tighten_rows(
    C: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Row tightening: u_i = min_j (C_ij - v_j), so each valid row has a
    zero reduced cost."""
    red = C - v[..., None, :]
    if mask is not None:
        red = torch.where(_mask2d(mask), red, BIG)
    u = red.amin(-1)
    if mask is not None:
        u = torch.where(mask, u, 0.0)
    return u


def project_feasible(
    C: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    max_rounds: int = 50,
    tol: float = 1e-12,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cap (u, v) until dual-feasible: alternate u <- min(u, min_j(C - v))
    and v <- min(v, min_i(C - u)) while the batch's minimum reduced cost is
    below -tol, at most ``max_rounds`` rounds.  Each round's test is one
    host read (a device sync on a CUDA tensor); no evaluation or serving
    path calls this."""
    m2 = None if mask is None else _mask2d(mask)

    def masked(red):
        return red if m2 is None else torch.where(m2, red, BIG)

    rounds = 0
    while rounds < max_rounds and bool(masked(reduced_costs(C, u, v)).amin() < -tol):
        u = torch.minimum(u, masked(C - v[..., None, :]).amin(-1))
        v = torch.minimum(v, masked(C - u[..., :, None]).amin(-2))
        rounds += 1
    if mask is not None:
        u = torch.where(mask, u, 0.0)
        v = torch.where(mask, v, 0.0)
    return u, v


def dual_objective(
    u: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Lower bound sum(u) + sum(v) on the optimal assignment cost."""
    if mask is not None:
        mf = mask.to(u.dtype)
        return (u * mf).sum(-1) + (v * mf).sum(-1)
    return u.sum(-1) + v.sum(-1)


def check_dual_feasible(
    C: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    tol: float = 1e-8,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Boolean per batch element: the minimum reduced cost >= -tol."""
    red = reduced_costs(C, u, v)
    if mask is not None:
        red = torch.where(_mask2d(mask), red, 0.0)
    return red.amin((-2, -1)) >= -tol


def check_complementary_slackness(
    C: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    col_of_row: torch.Tensor,
    tol: float = 1e-6,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """|C[i, x_i] - u_i - v_{x_i}| <= tol on every matched edge, per batch
    element; ``col_of_row`` is the matching as a column per row."""
    red = reduced_costs(C, u, v)
    matched = torch.gather(red, -1, col_of_row.long()[..., :, None])[..., 0]
    ok = matched.abs() <= tol
    if mask is not None:
        ok = ok | ~mask
    return ok.all(-1)


def duals_from_matching(
    C: torch.Tensor,
    col_of_row: torch.Tensor,
    tol: float = 1e-12,
    max_rounds: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Optimal duals from an optimal matching: the min-plus fixpoint
    v_j <- min(v_j, min_i (C_ij - (C[i, p_i] - v[p_i]))) from v = 0, at most
    ``max_rounds`` (default n) rounds while some v drops by more than
    ``tol``; then u_i = C[i, p_i] - v[p_i], and both are shifted by
    (mean(u) + mean(v)) / 2 (masked means under ``mask``).  Each round's
    test is one host read (a device sync on a CUDA tensor); no evaluation
    or serving path calls this."""
    n = C.shape[-1]
    if max_rounds is None:
        max_rounds = n
    m2 = None if mask is None else _mask2d(mask)
    p = col_of_row.long()
    c_match = torch.gather(C, -1, p[..., :, None])[..., 0]

    v = torch.zeros(C.shape[:-1], dtype=C.dtype, device=C.device)
    rounds, changed = 0, True
    while rounds < max_rounds and changed:
        t = c_match - torch.gather(v, -1, p)
        cand = C - t[..., :, None]
        if m2 is not None:
            cand = torch.where(m2, cand, BIG)
        v_new = torch.minimum(v, cand.amin(-2))
        changed = bool((v_new < v - tol).any())
        v = v_new
        rounds += 1

    u = c_match - torch.gather(v, -1, p)
    if mask is not None:
        mf = mask.to(C.dtype)
        cnt = torch.clamp_min(mf.sum(-1, keepdim=True), 1.0)
        mu = (u * mf).sum(-1, keepdim=True) / cnt
        mv = (v * mf).sum(-1, keepdim=True) / cnt
    else:
        mu = u.mean(-1, keepdim=True)
        mv = v.mean(-1, keepdim=True)
    shift = (mu + mv) / 2.0
    u = u - shift
    v = v + shift
    if mask is not None:
        u = torch.where(mask, u, 0.0)
        v = torch.where(mask, v, 0.0)
    return u, v


def center_gauge(u: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean-center u per instance (the models' gauge fix)."""
    if mask is not None:
        mf = mask.to(u.dtype)
        cnt = torch.clamp_min(mf.sum(-1, keepdim=True), 1.0)
        mean_u = (u * mf).sum(-1, keepdim=True) / cnt
        return torch.where(mask, u - mean_u, 0.0)
    return u - u.mean(-1, keepdim=True)
