"""Forbidden-edge sentinel clipping (port of
``lapgnn_tpu/train/loss.py:clip_cost_sentinels``, the only part of the loss
module the predict path needs)."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["BIG", "clip_cost_sentinels"]

# Forbidden-edge sentinel of the sparse dataset family.
BIG = 1.0e6


def clip_cost_sentinels(
    cost: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    threshold: float = 0.5 * BIG,
) -> torch.Tensor:
    """Clip sentinels to the per-instance maximum of the real entries.

    Clipped <= true entrywise, so dual feasibility on the clipped problem
    implies feasibility on the true one.  An all-sentinel instance stays
    unclipped."""
    finite = cost < threshold
    if mask is not None:
        finite = finite & mask[..., :, None] & mask[..., None, :]
    fmax = torch.where(finite, cost, -torch.inf).amax((-2, -1), keepdim=True)
    fmax = torch.where(torch.isfinite(fmax), fmax, torch.inf)
    return torch.minimum(cost, fmax)
