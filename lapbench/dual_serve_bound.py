"""The least work of one DualGNN inference forward, and of one call of the
DualGNN-served solve, for the per-layer metrics of the cells that serve it.

Counted from what the mathematics of the forward needs, not from how the
model takes it.  Per layer and edge, in float32 matrix products:

  * the edge MLP's first two layers, 2*10*128 and 2*128*128;
  * the two edge terms, with ``edge_fc3`` folded into the (128 -> 2*heads)
    map it alone feeds: 2*128*2*heads.  The fold is exact, because the edge
    MLP's output is read only through the two edge terms
    (``lapgnn_tpu_torch/models/dual_gnn.py``), so a program that folds it
    cannot read above 100%;
  * the two attention messages, 2*2*hidden;

and per layer and node the four projections and the two updates, 16*h^2;
the encoders 4*14*h and the heads 4*h a node.  The least bytes are one read
of the edge features a layer.  ``yardstick.dual_forward_flops`` (the
training cell's count, with ``edge_fc3`` unfolded) is left as it is.
"""

from __future__ import annotations

from typing import Dict, Optional

from lapbench.yardstick import EDGE_DIM, EDGE_HIDDEN, F32_OPS_PER_S, HBM_BYTES_PER_S, NODE_DIM

__all__ = ["forward_bytes", "forward_flops", "forward_least_s", "instance_least_s",
           "model_roofline_pct", "solve_mfu_pct"]

F32 = 4


def forward_flops(n: int, hidden: int, layers: int, heads: int, B: int = 1) -> int:
    """Least float32 matrix-product FLOPs of one inference forward on B
    (n, n) instances."""
    h = hidden
    per_edge = (2 * EDGE_DIM * EDGE_HIDDEN + 2 * EDGE_HIDDEN * EDGE_HIDDEN
                + 2 * EDGE_HIDDEN * 2 * heads + 2 * 2 * h)
    per_layer = n * n * per_edge + 16 * n * h * h
    return B * (layers * per_layer + 4 * n * NODE_DIM * h + 4 * n * h)


def forward_bytes(n: int, layers: int, B: int = 1) -> int:
    """Least bytes of one forward: the float32 edge features read once a
    layer."""
    return B * layers * n * n * EDGE_DIM * F32


def forward_least_s(n: int, hidden: int, layers: int, heads: int) -> float:
    """Least time of one forward on one instance: its FLOPs at the float32
    rate against its bytes at the HBM rate."""
    return max(forward_flops(n, hidden, layers, heads) / F32_OPS_PER_S,
               forward_bytes(n, layers) / HBM_BYTES_PER_S)


def instance_least_s(n: int, hidden: int, layers: int, heads: int) -> float:
    """Least time of one instance of the served call (``pipeline._e2e``):
    the forward's FLOPs against its bytes and one read of the n x n float32
    matrix."""
    return max(forward_flops(n, hidden, layers, heads) / F32_OPS_PER_S,
               (forward_bytes(n, layers) + n * n * F32) / HBM_BYTES_PER_S)


def _widths(rec: Dict):
    cfg = rec["config"]
    return int(rec["n"]), int(cfg["hidden"]), int(cfg["layers"]), int(cfg["heads"])


def solve_mfu_pct(rec: Dict) -> Optional[float]:
    """Instances completed in the window times the least time of one, over
    the window (%)."""
    if not rec.get("instances") or rec["window_s"] <= 0:
        return None
    return 100.0 * rec["instances"] * instance_least_s(*_widths(rec)) / rec["window_s"]


def model_roofline_pct(rec: Dict, model_ms: Optional[float]) -> Optional[float]:
    """The forward's least time over the mean time of the model's span (%)."""
    if not model_ms or model_ms <= 0:
        return None
    return 100.0 * forward_least_s(*_widths(rec)) * 1e3 / model_ms
