"""Padding utilities for mixed-size instance batches (numpy).

Port of ``lapgnn_tpu/ops/padding.py``.  A padded cost matrix embeds the real
instance in the top-left block and a zero-cost block in the bottom-right,
with ``BIG`` between them, so a solver run on the padded matrix matches pad
rows to pad columns and the restriction to the valid block is the original
optimum.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .dual import BIG

__all__ = ["pad_cost_matrix", "pad_batch", "unpad_assignment"]


def pad_cost_matrix(C: np.ndarray, target_n: int, off_block: float = BIG) -> np.ndarray:
    """Embed (n, n) costs into (target_n, target_n): pad rows and columns
    cost ``off_block`` against the valid block and 0 against each other."""
    n = C.shape[0]
    if n > target_n:
        raise ValueError(f"cannot pad n={n} down to {target_n}")
    if n == target_n:
        return np.asarray(C)
    out = np.full((target_n, target_n), off_block, dtype=np.asarray(C).dtype)
    out[:n, :n] = C
    out[n:, n:] = 0.0
    return out


def pad_batch(
    costs: Sequence[np.ndarray], target_n: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack ragged instances into ((B, N, N) costs, (B, N) valid-row mask)."""
    if not costs:
        raise ValueError("empty batch")
    N = target_n or max(c.shape[0] for c in costs)
    out = np.stack([pad_cost_matrix(c, N) for c in costs])
    mask = np.zeros((len(costs), N), dtype=bool)
    for b, c in enumerate(costs):
        mask[b, : c.shape[0]] = True
    return out, mask


def unpad_assignment(col_of_row: np.ndarray, n: int) -> np.ndarray:
    """Restrict a padded assignment to the valid block (first n rows)."""
    x = np.asarray(col_of_row)[:n]
    if (x >= n).any():
        raise ValueError("padded assignment crosses the valid block")
    return x
