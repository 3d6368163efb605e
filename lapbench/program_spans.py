"""The program's own spans and counters (``lapgnn_tpu_torch.tracing``),
for the per-layer metrics that read them.

The program's tracer records while ``torch.profiler`` records, so in a
traced run it holds the window's spans alone: set-up runs before the
profiler starts and the check after it stops.  A program without the tracer
gives nothing to read, and each reader then returns None.  The first read
of a run's spans logs each span's calls and mean ms to standard error.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

__all__ = ["mean_count", "mean_ms"]

_logged = None


def _recorded() -> List:
    global _logged
    try:
        from lapgnn_tpu_torch import tracing
    except ImportError:
        return []
    spans = tracing.recorded()
    key = (len(spans), spans[0].id if spans else None)
    if spans and key != _logged:
        _logged = key
        by_name = {}
        for s in spans:
            by_name.setdefault(s.name, []).append(s.ms)
        print("program spans (name: calls, mean ms): " + json.dumps(
            {k: [len(v), sum(v) / len(v)] for k, v in sorted(by_name.items())}),
            file=sys.stderr, flush=True)
    return spans


def _named(name: str) -> List:
    return [s for s in _recorded() if s.name == name]


def mean_ms(name: str, host: bool = False) -> Optional[float]:
    """Mean time of the spans ``name``: by their CUDA events (the host
    clock for host-only spans, or with ``host``), ms; None without one."""
    spans = _named(name)
    if not spans:
        return None
    return sum(s.host_ms if host else s.ms for s in spans) / len(spans)


def mean_count(name: str, counter: str) -> Optional[float]:
    """Mean rise of ``counter`` over the spans ``name``; None without one."""
    spans = _named(name)
    if not spans:
        return None
    return sum(s.counts(counter) for s in spans) / len(spans)
