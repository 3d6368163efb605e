"""The least time of one OneGNN progressive training step, for the per-layer
metric ``step_mfu.one_train``.

A step of B instances at n: its model FLOPs, three forwards
(``yardstick.one_gnn_forward_flops``: the forward, and a backward of twice
it), at the float32 rate, against one read of the batch's float32 costs at
the HBM rate; the larger of the two.  The O(B n^2) passes of the features,
the top-k, the loss and the greedy bound are not charged beyond that one
read, so the share shows how far the step is from the least any
implementation needs.
"""

from __future__ import annotations

from typing import Dict, Optional

from lapbench.yardstick import F32_OPS_PER_S, HBM_BYTES_PER_S, one_gnn_forward_flops

__all__ = ["step_bytes", "step_flops", "step_least_s", "step_mfu_pct"]

F32 = 4


def step_flops(n: int, hidden: int, layers: int, topk: int, B: int) -> int:
    """Model FLOPs of one training step on B (n, n) instances."""
    return 3 * B * one_gnn_forward_flops(n, hidden, layers, topk)


def step_bytes(n: int, B: int) -> int:
    """Least bytes of one step: the batch's float32 costs read once."""
    return B * n * n * F32


def step_least_s(n: int, hidden: int, layers: int, topk: int, B: int) -> float:
    return max(step_flops(n, hidden, layers, topk, B) / F32_OPS_PER_S,
               step_bytes(n, B) / HBM_BYTES_PER_S)


def step_mfu_pct(rec: Dict) -> Optional[float]:
    """Steps in the window times the least time of one, over the window (%)."""
    if not rec.get("steps") or rec["window_s"] <= 0:
        return None
    cfg = rec["config"]
    least = step_least_s(int(rec["n"]), int(cfg["hidden"]), int(cfg["layers"]), int(cfg["topk"]),
                         int(rec["batch"]))
    return 100.0 * rec["steps"] * least / rec["window_s"]
