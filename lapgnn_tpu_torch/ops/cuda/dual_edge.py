"""DualGNN's edge MLP folded into its two edge terms: CUDA kernel and plain version.

Replaces the edge MLP of ``lapgnn_tpu/models/dual_gnn.py`` (``DualLayer``,
:107-112), a plain ``nn.Dense`` chain with no Pallas kernel behind it.
Eagerly the port ran it as five launches over every edge, each writing its
whole activation to device memory (2 GiB for fc1, both GELUs and fc2, 4 GiB
for fc3 at n = 2048), then a product with the block-diagonal edge weight.
The MLP's output is read only through that product, so fc3 folds into it
(``fold_edge_weights``: Wf = W3ᵀ·E, bf = b3·E, made on the card in each
forward), and the kernel (``csrc/dual_edge.cu``) maps each edge's 10
features straight to its 2·heads edge terms:

    t = GELU(GELU(x·W1ᵀ + b1)·W2ᵀ + b2)·Wf + bf      (exact GELU)

Bound on this card: 2·10·128 + 2·128·128 + 2·128·out float32 operations an
edge (156.8 GFLOP a layer at n = 2048 and 4 heads: 2.34 ms at 67 TFLOP/s)
against 40 bytes in and 4·out out an edge (0.09 ms at 3.35 TB/s): bound by
the float32 FMA pipes.  The design keeps every 128-wide activation on chip:
a persistent grid, the weights in each block's shared memory for the
launch, tiles of 128 edges; four producer warps copy a tile's features in
by ``cp.async`` and run fc1 into one of two h1 buffers in shared memory
while eight consumer warps run fc2 (a register-tiled product, its GELU in
registers) and the fold (reduced across a half-warp by shuffles) on the
other.

Agreement: the sums run in another order than the eager chain's (fc3's and
E's dot products meet in one), so the terms agree with the unfolded chain
within float32 rounding, not bit for bit: ``tolerance`` allows ``RTOL`` of
each instance's largest |term|, where the fold alone moved them at most
7.3e-7 of it (the eight families at n = 24, r5's widths, three seeds, on the
CPU) and the kernel moved them at most 5.9e-7 from the plain version on the
card.  ``dual_edge_terms_plain`` is the same folded arithmetic in PyTorch.
``dual_edge_terms`` launches the kernel on CUDA float32 tensors and raises on
any other input (``DualLayer.forward`` decides which inputs reach it); it
counts its launches in ``.launches`` and the tracer's ``dual_edge_kernel``
counter.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.nn import functional as F

from ... import tracing

__all__ = ["MAX_OUT", "RTOL", "dual_edge_terms", "dual_edge_terms_plain", "fold_edge_weights",
           "tolerance"]

IN = 10  # csrc/dual_edge.cu's kIn: features an edge
HIDDEN = 128  # csrc/dual_edge.cu's kHid: the edge MLP's width
MAX_OUT = 32  # csrc/dual_edge.cu's kMaxOut: edge terms an edge
# The kernel against the plain version, and the fold against the unfolded
# chain: |difference| <= RTOL * max|term| an instance.
RTOL = 1e-5


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def fold_edge_weights(w3: torch.Tensor, b3: torch.Tensor,
                      edge_weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fc3 folded into the (hidden, out) edge weight E it alone feeds:
    (Wf, bf) = (W3ᵀ·E, b3·E), (128, out) and (out,), on E's device."""
    return w3.t() @ edge_weight, b3 @ edge_weight


def tolerance(terms: torch.Tensor) -> torch.Tensor:
    """(B, 1, 1, 1): how far two (B, N, M, out) edge-term tensors may lie
    apart, ``RTOL`` times each instance's largest finite |term|."""
    finite = torch.where(torch.isfinite(terms), terms.abs(), torch.zeros_like(terms))
    return RTOL * finite.amax((1, 2, 3), keepdim=True)


def dual_edge_terms_plain(edge_feat, w1, b1, w2, b2, wf, bf) -> torch.Tensor:
    """(B, N, M, 10) edge features -> (B, N, M, out) edge terms: fc1, GELU,
    fc2, GELU, then the folded (Wf, bf)."""
    h = _gelu(F.linear(edge_feat, w1, b1))
    h = _gelu(F.linear(h, w2, b2))
    return torch.matmul(h, wf) + bf


def _check(edge_feat, w1, b1, w2, b2, wf, bf) -> None:
    named = (("edge_feat", edge_feat), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2),
             ("wf", wf), ("bf", bf))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"dual_edge_terms: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"dual_edge_terms: {name} must be contiguous")
        if t.device != edge_feat.device:
            raise ValueError(f"dual_edge_terms: {name} is on {t.device}, edge_feat on "
                             f"{edge_feat.device}")
    if edge_feat.ndim != 4 or edge_feat.shape[-1] != IN:
        raise ValueError(f"dual_edge_terms: edge_feat must be (B, N, M, {IN}), got "
                         f"{tuple(edge_feat.shape)}")
    out = wf.shape[-1] if wf.ndim == 2 else -1
    want = {"w1": (HIDDEN, IN), "b1": (HIDDEN,), "w2": (HIDDEN, HIDDEN), "b2": (HIDDEN,),
            "wf": (HIDDEN, out), "bf": (out,)}
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"dual_edge_terms: {name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
    if not 1 <= out <= MAX_OUT:
        raise ValueError(f"dual_edge_terms: {out} terms an edge, the kernel takes 1 to {MAX_OUT}")
    if edge_feat.device.type != "cuda":
        raise ValueError(f"dual_edge_terms: unsupported device {edge_feat.device}")


def dual_edge_terms(edge_feat, w1, b1, w2, b2, wf, bf) -> torch.Tensor:
    """The edge terms of (B, N, M, 10) CUDA float32 ``edge_feat`` under fc1
    (w1, b1), fc2 (w2, b2) and the folded (wf, bf): (B, N, M, out), by the
    kernel on the current stream; reads nothing back."""
    _check(edge_feat, w1, b1, w2, b2, wf, bf)
    from ._lib import KERNEL_LIBS, check, ptr, sm_count, stream_ptr

    out_dim = wf.shape[-1]
    dev = edge_feat.device
    terms = torch.empty(edge_feat.shape[:-1] + (out_dim,), dtype=torch.float32, device=dev)
    edges = edge_feat.numel() // IN
    if edges == 0:
        return terms
    lib = KERNEL_LIBS["dual_edge"].load()
    with torch.cuda.device(dev):
        # one block an SM: its shared memory (217,120 B at 8 terms) holds no second
        blocks = min(-(-edges // 128), sm_count(dev))  # csrc/dual_edge.cu's kTile
        rc = lib.lapgnn_dual_edge(ptr(edge_feat), ptr(w1), ptr(b1), ptr(w2), ptr(b2), ptr(wf),
                                  ptr(bf), ptr(terms), edges, out_dim, blocks, stream_ptr(dev))
    check(rc, "dual_edge_terms kernel")
    dual_edge_terms.launches += 1
    tracing.count("dual_edge_kernel")
    return terms


dual_edge_terms.launches = 0
