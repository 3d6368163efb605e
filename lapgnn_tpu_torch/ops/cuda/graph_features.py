"""DualGNN's dense graph features: two CUDA kernels, a column pass and a row pass.

Replaces no Pallas kernel: the JAX package computes these features in plain
``jnp`` (``lapgnn_tpu/ops/features.py:graph_features``), which XLA compiles.
Eagerly the port ran the same sort-based chain (``ops.features.
graph_features_plain``, also this kernel's plain version): two value sorts,
two stable argsorts, a 12-step bisection of about 14 small ops for each half
of each axis's MAD, the 10-way stack and the positional code, about 800
launches and several blocking copies of constants a call, while the card
waited for the host.

``csrc/graph_features.cu`` computes the same features in two launches with
no host copy: the column pass (one block a column) sorts each column in
shared memory by (value, index) as one 64-bit key, takes its order
statistics from the sorted column, writes the column node features, each
entry's column rank and the column's min, tie fraction and entropy; the row
pass (one block a row) does the same on its row and writes the row node
features and the whole interleaved edge row, coalesced.

Bound on this card: bytes, C read once and the edge tensor written once:
(4 + 40) B an entry, 0.055 ms at (1, 2048) and 0.014 ms at (4, 512) at
3.35 TB/s (the design moves 56 B an entry: both passes read C, and the
column ranks go out and back).  The shared-memory sorts set the pace (a bitonic network,
L/2·log2 L·(log2 L + 1)/2 compare-exchanges a line padded to L, 67,584 at
2048); the design keeps the line in shared memory for the block's whole
life, runs every stage that stays inside a warp's 64-key segment under
``__syncwarp`` instead of a block barrier, and stages the edge row a warp's
32 edges at a time so that every store is 128 contiguous bytes.

Agreement with the plain version on the card, as ``check_against_plain``
holds it: ranks, min, max, median, MAD, gaps, tie fractions, the scaled cost,
the zero channel and the positional columns bit for bit (the same float
expressions over the same sorted values, and the MAD by the plain version's
own bisection, so a NaN lands where it lands there; -0.0 and +0.0 sort as
equal, as torch's sort has them, so only the sign of a zero may differ where
torch's reductions or its unstable short sort pick the other one); mean, std
and entropy within ``ULPS``, summed in another order.

``graph_features`` takes a contiguous CUDA float32 (n, m) or (B, n, m)
tensor and raises on any other; ``ops.features.graph_features`` decides
which calls reach it.  It counts its two launches a call in the tracer's
``launch.graph_features``.  Its outputs carry no gradient.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

__all__ = ["EDGE_DIM", "NODE_DIM", "ULPS", "check_against_plain", "graph_features",
           "graph_features_max_len"]

NODE_DIM = 14  # csrc/graph_features.cu's kNodeDim
EDGE_DIM = 10  # kEdgeDim
TAU = 1e-3  # kTau
EPS = 1e-9  # kEps
POS_FREQS = (1, 2, 4, 8)  # kFreqs of them, doubling
MAX_BATCH = 65535  # the grid's y extent

# mean, std and entropy: |kernel - plain| <= ULPS * float32 eps * scale, the
# scale max|x| of the line for mean and std (a sum's rounding grows with the
# terms it adds), the plain entropy itself for the entropy (a sum of terms
# >= 0); the largest seen on an H100 over chip_smoke.py's families and
# shapes: 1.23, 1.0 and 4.0
ULPS = {"mean": 4, "std": 4, "entropy": 16}
_EXACT_EDGE = (0, 1, 2, 3, 4, 5, 6, 9)  # every edge channel but the entropies
_EXACT_NODE = (0, 1, 4, *range(6, NODE_DIM))  # min, max, MAD, positional columns
_SUMMED_NODE = {"mean": 2, "std": 3, "entropy": 5}


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, but a zero of either sign, and NaN for NaN."""
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | ((a == 0) & (b == 0))
                 | (torch.isnan(a) & torch.isnan(b))).all())


def _ulps(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> float:
    """Largest |got - want| in float32 epsilons of ``scale``; NaN on both
    sides is 0, NaN on one side infinite."""
    eps = float(np.finfo(np.float32).eps)
    d = (got - want).abs() / (eps * scale.clamp_min(1e-30))
    both = torch.isnan(got) & torch.isnan(want)
    d = torch.where(both, torch.zeros_like(d), torch.nan_to_num(d, nan=float("inf")))
    return float(d.max()) if d.numel() else 0.0


def check_against_plain(C: torch.Tensor, got: Sequence[torch.Tensor],
                        want: Sequence[torch.Tensor]) -> Dict[str, float]:
    """Hold the kernels' features ``got`` (row, column, edge) of the (n, m)
    or (B, n, m) cost ``C`` to the plain version's ``want`` on the same card.

    Bit for bit (``_same``): every edge channel but the entropies, and min,
    max, MAD and the positional columns of rows and columns; the edge's
    entropy channels equal the kernels' own node entropies, broadcast; mean,
    std and entropy within ``ULPS``.  Raises AssertionError naming the first
    channel that fails; returns the largest ulps of each summed channel, as
    ``{"row_mean": ..., "col_entropy": ...}``."""
    rows, cols, edge = (t.detach().cpu() for t in got)
    p_rows, p_cols, p_edge = (t.detach().cpu() for t in want)
    for ch in _EXACT_EDGE:
        if not _same(edge[..., ch], p_edge[..., ch]):
            raise AssertionError(f"graph_features: edge channel {ch} differs")
    if not _same(edge[..., 7], rows[..., 5, None].expand_as(edge[..., 7])):
        raise AssertionError("graph_features: edge channel 7 differs from the row entropies")
    if not _same(edge[..., 8], cols[..., None, :, 5].expand_as(edge[..., 8])):
        raise AssertionError("graph_features: edge channel 8 differs from the column entropies")
    Cc = C.detach().cpu().to(torch.float32)
    ulps = {}
    for name, node, plain, scale in (("row", rows, p_rows, Cc.abs().amax(-1)),
                                     ("col", cols, p_cols, Cc.abs().amax(-2))):
        for ch in _EXACT_NODE:
            if not _same(node[..., ch], plain[..., ch]):
                raise AssertionError(f"graph_features: {name} feature {ch} differs")
        for stat, ch in _SUMMED_NODE.items():
            sc = plain[..., ch].abs() if stat == "entropy" else scale
            u = _ulps(node[..., ch], plain[..., ch], sc)
            ulps[f"{name}_{stat}"] = u
            if not u <= ULPS[stat]:
                raise AssertionError(f"graph_features: {name} {stat} {u:.3g} ulps, over "
                                     f"{ULPS[stat]}")
    return ulps


def graph_features_max_len(device: torch.device) -> int:
    """The longest row or column (n or m) the kernels take on a CUDA
    ``device``: the largest power of two whose row pass fits its shared
    memory a block (8192 on an H100)."""
    return _max_len(device.index if device.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _max_len(index: int) -> int:
    from ._lib import KERNEL_LIBS, check

    lib = KERNEL_LIBS["graph_features"].load()
    with torch.cuda.device(index):
        max_len = lib.lapgnn_graph_features_max_len(index)
    if max_len < 0:
        check(-max_len, "graph_features shared-memory query")
    return max_len


def graph_features(C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row features (…, n, 14), column features (…, m, 14) and edge features
    (…, n, m, 10) of a CUDA float32 (n, m) or (B, n, m) cost, by the two
    kernels on the current stream; reads nothing back."""
    if not (C.device.type == "cuda" and C.dtype == torch.float32 and C.ndim in (2, 3)
            and C.is_contiguous() and C.numel() > 0
            and (C.ndim == 2 or C.shape[0] <= MAX_BATCH)
            and max(C.shape[-2:]) <= graph_features_max_len(C.device)):
        raise ValueError(f"graph_features kernel: takes a contiguous CUDA float32 (n, m) or "
                         f"(B <= {MAX_BATCH}, n, m) cost with n and m up to "
                         f"graph_features_max_len; got {C.dtype} {tuple(C.shape)} on "
                         f"{C.device}")
    Cb = C if C.ndim == 3 else C[None]
    B, n, m = Cb.shape
    from ._lib import KERNEL_LIBS, launched, ptr, stream_ptr

    dev = C.device
    row = torch.empty((B, n, NODE_DIM), dtype=torch.float32, device=dev)
    col = torch.empty((B, m, NODE_DIM), dtype=torch.float32, device=dev)
    edge = torch.empty((B, n, m, EDGE_DIM), dtype=torch.float32, device=dev)
    col_rank = torch.empty((B, n, m), dtype=torch.float32, device=dev)
    col_aux = torch.empty((B, m, 4), dtype=torch.float32, device=dev)
    lib = KERNEL_LIBS["graph_features"].load()
    with torch.cuda.device(dev):
        stream = stream_ptr(dev)
        rc = lib.lapgnn_graph_features_cols(ptr(Cb), ptr(col), ptr(col_rank), ptr(col_aux),
                                            B, n, m, stream)
        launched(rc, "graph_features column kernel", "graph_features")
        rc = lib.lapgnn_graph_features_rows(ptr(Cb), ptr(row), ptr(col_rank), ptr(col_aux),
                                            ptr(edge), B, n, m, stream)
        launched(rc, "graph_features row kernel", "graph_features")
    if C.ndim == 2:
        return row[0], col[0], edge[0]
    return row, col, edge
