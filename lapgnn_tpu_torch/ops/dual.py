"""Dual-potential math for the Linear Assignment Problem, batched in PyTorch.

Port of ``lapgnn_tpu/ops/dual.py`` (the functions the warm-start predict path
runs).  Convention, as there:

  C : (..., n, n) cost matrix
  u : (..., n)    row dual potentials
  v : (..., n)    column dual potentials

Feasibility means ``C[i, j] - u[i] - v[j] >= -tol`` for all (i, j).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .cuda.colmin import min_trick

__all__ = [
    "BIG",
    "min_trick_v",
    "fast_min_trick",
    "robust_normalize",
    "center_gauge",
]

# Large-but-safe sentinel for masked entries (lapgnn_tpu/ops/dual.py:54).
BIG = 1.0e6


def _mask2d(mask: torch.Tensor) -> torch.Tensor:
    return mask[..., :, None] & mask[..., None, :]


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
    C: torch.Tensor, sentinel: float = 0.5e6, clip: float = 3.0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-instance affine normalization robust to forbidden-edge sentinels.

    The scale comes from the sub-sentinel entries only; sentinel entries land
    above 1 and are clipped to ``clip``.  Returns (C_normalized, mn, a) with
    C = a*C' + mn exact on the sub-sentinel entries."""
    is_real = C < sentinel
    # +/-inf fills, not +/-BIG: a -BIG fill could win the max when every real
    # entry is below -1e6 (see the JAX version).
    mn = torch.where(is_real, C, torch.inf).amin((-2, -1), keepdim=True)
    mx = torch.where(is_real, C, -torch.inf).amax((-2, -1), keepdim=True)
    any_real = is_real.flatten(-2).any(-1)[..., None, None]
    mn = torch.where(any_real, mn, C.amin((-2, -1), keepdim=True))
    mx = torch.where(any_real, mx, C.amax((-2, -1), keepdim=True))
    a = torch.clamp_min(mx - mn, 1e-12)
    C_n = torch.clamp_max((C - mn) / a, clip)
    return C_n, mn[..., 0, 0], a[..., 0, 0]


def center_gauge(u: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean-center u per instance (the models' gauge fix)."""
    if mask is not None:
        mf = mask.to(u.dtype)
        cnt = torch.clamp_min(mf.sum(-1, keepdim=True), 1.0)
        mean_u = (u * mf).sum(-1, keepdim=True) / cnt
        return torch.where(mask, u - mean_u, 0.0)
    return u - u.mean(-1, keepdim=True)
