"""Rigorous wall-clock timing harness (port of ``lapgnn_tpu/bench/harness.py``).

N warmup runs discarded, R measured repeats, median / mean / std / min / max
reported; a failure in the repeats returns ``{'success': False}`` instead of
raising.  The host clock is right only if ``fn`` returns after the device
work it started has finished: a ``fn`` that returns CUDA tensors must come
with a ``block`` that synchronises (``synchronize_block``), since kernel
launches are asynchronous.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

__all__ = ["time_rigorous", "synchronize_block"]


def synchronize_block(out: Any) -> None:
    """A ``block`` for ``time_rigorous``: waits for every CUDA device that
    holds a tensor of ``out`` (a tensor, or a tuple, list or dict of them)."""
    for device in {t.device for t in _tensors(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


def _tensors(out: Any):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)


def time_rigorous(
    fn: Callable[[], Any],
    warmups: int = 5,
    repeats: int = 30,
    block: Optional[Callable[[Any], Any]] = None,
) -> Dict[str, Any]:
    """Time ``fn`` with warmups + repeats; returns a stats dict in seconds.

    Warmup exceptions are swallowed (a lazy one-time init may fail once and
    then work); a failure during the timed repeats marks the measurement
    unsuccessful.
    """
    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    for _ in range(warmups):
        try:
            out = fn()
            if block is not None:
                block(out)
        except Exception:
            pass
    try:
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = fn()
            if block is not None:
                block(out)
            times.append(time.perf_counter() - t0)
        arr = np.asarray(times)
        return {
            "success": True,
            "median": float(np.median(arr)),
            "mean": float(arr.mean()),
            # the sample standard deviation (ddof=1)
            "std": float(arr.std(ddof=1)) if len(arr) > 1 else 0.0,
            "min": float(arr.min()),
            "max": float(arr.max()),
            "repeats": repeats,
            "result": out,
        }
    except Exception as exc:
        return {"success": False, "error": str(exc)}
