"""Spans around the program's calls, and the device trace of a window.

``Spans`` wraps a callable of the program so that each call is timed: on
the card by CUDA events recorded on the current stream around it (read
once the window has closed, so the timing adds no sync), on the host by the
clock.  Each call also opens a ``torch.profiler.record_function`` range of
the span's name, so that the trace can say what the host was doing while
the device idled.

``DeviceTrace`` runs ``torch.profiler`` over the window and reduces its
events: the seconds in which some operation ran on the device (the union
of the kernels', copies' and sets' intervals), the window's length, the
time and launches of each kernel by name, and the idle gaps by the
benchmark's innermost span that held the host at their middle.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

__all__ = ["DeviceTrace", "Spans"]


class Spans:
    """Named spans; ``wrap(fn, name)`` returns ``fn`` timed under ``name``."""

    def __init__(self, device: torch.device):
        self.device = device
        self._events: Dict[str, List[Tuple]] = defaultdict(list)
        self.host_ms: Dict[str, List[float]] = defaultdict(list)

    def wrap(self, fn: Callable, name: str) -> Callable:
        on_card = self.device.type == "cuda"

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with torch.profiler.record_function(f"lapbench.{name}"):
                t0 = time.perf_counter()
                if on_card:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = fn(*args, **kwargs)
                    end.record()
                    self._events[name].append((start, end))
                else:
                    out = fn(*args, **kwargs)
                self.host_ms[name].append((time.perf_counter() - t0) * 1e3)
            return out

        return timed

    def device_ms(self) -> Dict[str, List[float]]:
        """Each span's device times (ms), by CUDA events; host times off
        the card."""
        out = {name: list(ms) for name, ms in self.host_ms.items()}
        for name, pairs in self._events.items():
            if pairs:
                pairs[-1][1].synchronize()
                out[name] = [s.elapsed_time(e) for s, e in pairs]
        return out


class DeviceTrace:
    """``with DeviceTrace(): ...`` profiles the block; ``summary()`` then
    gives the reduced trace."""

    def __init__(self):
        self._prof = None
        self.window_s = 0.0

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        return False

    def _events(self):
        results = self._prof.profiler.kineto_results
        dev, cpu = [], []
        for ev in results.events():
            start, dur = ev.start_ns(), ev.duration_ns()
            if dur <= 0:
                continue
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                # the device side of a record_function range is no operation
                if ev.is_user_annotation() or ev.name().startswith("lapbench."):
                    continue
                dev.append((start, start + dur, ev.name()))
            else:
                cpu.append((start, start + dur, ev.name()))
        return dev, cpu

    def summary(self, top: int = 10) -> Dict:
        """busy_s, window_s, kernels {name: [launches, seconds]} and the
        breakdown's device_ops and idle_gaps (each at most ``top`` long):
        every idle gap of the device, summed by the innermost benchmark span
        that held the host at its middle."""
        dev, cpu = self._events()
        kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
        for s, e, name in dev:
            k = kernels[name]
            k[0] += 1
            k[1] += (e - s) * 1e-9
        busy_ns, gaps = _union(dev)
        idle: Dict[str, float] = defaultdict(float)
        for label, seconds in zip(_span_labels(cpu, gaps), gaps):
            idle[label] += (seconds[1] - seconds[0]) * 1e-9
        device_ops = sorted(([n, k[1]] for n, k in kernels.items()), key=lambda x: -x[1])[:top]
        return {
            "busy_s": busy_ns * 1e-9,
            "window_s": self.window_s,
            "kernels": {n: [k[0], k[1]] for n, k in kernels.items()},
            "device_ops": [[n[:160], s] for n, s in device_ops],
            "idle_gaps": sorted(([n, s] for n, s in idle.items()), key=lambda x: -x[1])[:top],
        }


def _union(intervals) -> Tuple[int, List[Tuple[int, int]]]:
    """Total length of the union of [start, end) intervals, and the gaps
    between its pieces."""
    if not intervals:
        return 0, []
    iv = sorted((s, e) for s, e, _ in intervals)
    busy, gaps = 0, []
    cur_s, cur_e = iv[0]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    busy += cur_e - cur_s
    return busy, gaps


def _span_labels(cpu, gaps) -> List[str]:
    """For each gap, the innermost ``lapbench.*`` range (on any host thread)
    that holds its middle; "outside every span" where none does."""
    labels = ["outside every span"] * len(gaps)
    if not gaps:
        return labels
    mids = np.array([(g0 + g1) // 2 for g0, g1 in gaps], dtype=np.int64)
    order = np.argsort(mids)
    sorted_mids = mids[order]
    held = np.full(len(gaps), np.iinfo(np.int64).max)
    ranges = sorted((c for c in cpu if c[2].startswith("lapbench.")), key=lambda c: c[0] - c[1])
    for start, end, name in ranges:  # longest first, so inner ranges overwrite
        lo, hi = np.searchsorted(sorted_mids, [start, end])
        for i in order[lo:hi]:
            if end - start <= held[i]:
                held[i] = end - start
                labels[i] = name
    return labels
