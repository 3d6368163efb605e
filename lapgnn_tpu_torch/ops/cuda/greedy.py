"""Greedy primal upper bound of the training loss: CUDA kernel and plain version.

The JAX loss computes the bound as a ``lax.scan`` over the rows
(``lapgnn_tpu/train/loss.py:_greedy_single``, :79), which XLA compiles into
one loop on the device; it has no Pallas kernel.  Written as eager PyTorch
the scan is n host-driven steps of about six launches each, 12K launches a
train step at n = 2048, so the port runs it as one hand-written kernel
(``csrc/greedy.cu``): one thread block per instance, the used columns as a
bitmap in shared memory, a block-wide (value, index) argmin each step.

Bound on this card: the scan is sequential, n dependent steps an instance,
so the floor is n times the latency of one step (a row read and two block
barriers), far above the time its bytes (red read once, ``B*n*n*4``) take
at 3.35 TB/s.

``greedy_total_plain`` is the batched transcription of ``_greedy_single``:
rows in the given order, each takes its cheapest still-unused column (first
index on ties, NaN smallest, as ``argmin``), the sum accumulated in float32
in visiting order.  The kernel equals it bit for bit.  A CUDA tensor
launches the kernel (or raises); only a CPU tensor takes the plain version.
The wrapper counts its kernel launches in the tracer's ``launch.greedy_total``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["greedy_threads", "greedy_total", "greedy_total_kernel", "greedy_total_plain"]

MAX_THREADS = 1024
# The used-column bitmap lives in shared memory, one bit a column.
MAX_N = 1 << 20


def greedy_threads(n: int) -> int:
    """Threads of the kernel's block for rows of n columns: one column a
    thread rounded up to whole warps, at most 1024 (longer rows stride)."""
    return min(MAX_THREADS, 32 * -(-n // 32))


def greedy_total_plain(
    red: torch.Tensor,
    cost: torch.Tensor,
    order: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, n, n) reduced costs and costs, (B, n) visiting order and optional
    row mask -> (B,) totals: each row in turn takes its cheapest unused column
    of ``red`` and adds that column's ``cost``; a masked row adds 0 and
    leaves its column free."""
    B, n, _ = red.shape
    ar = torch.arange(B, device=red.device)
    used = torch.zeros((B, n), dtype=torch.bool, device=red.device)
    total = torch.zeros((B,), dtype=cost.dtype, device=red.device)
    inf = torch.tensor(torch.inf, dtype=red.dtype, device=red.device)
    for t in range(n):
        row = order[:, t]
        j = torch.where(used, inf, red[ar, row]).argmin(-1)
        picked = cost[ar, row, j]
        if valid is None:
            used[ar, j] = True
            total = total + picked
        else:
            ok = valid[ar, row]
            used[ar, j] = used[ar, j] | ok
            total = total + torch.where(ok, picked, 0.0)
    return total


def _check(red, cost, order, valid) -> None:
    if red.dtype != torch.float32 or cost.dtype != torch.float32:
        raise TypeError(f"greedy_total: red and cost must be float32, got {red.dtype}, {cost.dtype}")
    if red.ndim != 3 or red.shape[-1] != red.shape[-2] or cost.shape != red.shape:
        raise ValueError(
            f"greedy_total: takes square (B, n, n) red and cost, got "
            f"{tuple(red.shape)}, {tuple(cost.shape)}"
        )
    B, n, _ = red.shape
    if order.dtype != torch.int64 or tuple(order.shape) != (B, n):
        raise ValueError(f"greedy_total: order must be int64 ({B}, {n}), got {order.dtype} {tuple(order.shape)}")
    if valid is not None and (valid.dtype != torch.bool or tuple(valid.shape) != (B, n)):
        raise ValueError(f"greedy_total: valid must be bool ({B}, {n})")
    tensors = [red, cost, order] + ([] if valid is None else [valid])
    if any(t.device != red.device for t in tensors):
        raise ValueError("greedy_total: all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("greedy_total: inputs must be contiguous")
    if B < 1 or n < 1 or n > MAX_N or B >= 2**31:
        raise ValueError(f"greedy_total: shape {tuple(red.shape)} outside the kernel's range")


def greedy_total_kernel(
    red: torch.Tensor,
    cost: torch.Tensor,
    order: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel on CUDA tensors; launches on the current stream and reads
    nothing back."""
    if red.device.type != "cuda":
        raise ValueError(f"greedy_total: unsupported device {red.device}")
    _check(red, cost, order, valid)
    from ._lib import KERNEL_LIBS, launched, ptr, stream_ptr

    B, n, _ = red.shape
    lib = KERNEL_LIBS["greedy"].load()
    total = torch.empty((B,), dtype=torch.float32, device=red.device)
    with torch.cuda.device(red.device):
        rc = lib.lapgnn_greedy_total(
            ptr(red), ptr(cost), ptr(order), None if valid is None else ptr(valid),
            ptr(total), B, n, greedy_threads(n), stream_ptr(red.device),
        )
    launched(rc, "greedy_total kernel", "greedy_total")
    return total


def greedy_total(
    red: torch.Tensor,
    cost: torch.Tensor,
    order: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The greedy bound's totals, (B,) float32, bit-equal to
    ``greedy_total_plain``."""
    if red.device.type == "cpu":
        return greedy_total_plain(red, cost, order, valid)
    return greedy_total_kernel(red, cost, order, valid)
