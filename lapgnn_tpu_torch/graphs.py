"""CUDA graphs of the program's own steps: captured once for a shape, then
replayed.

``capture(fn, device)`` runs ``fn()`` under CUDA stream capture on a side
stream and returns a ``Recording``: the graphs of the work ``fn`` enqueued,
cut at every tracer span it opened (``tracing.cutting``), all in one memory
pool, each with what the capturing thread counted in the tracer's counters
while it was captured (held apart: capture runs nothing on the card), and
the tensors ``fn`` returned, which live in the pool.
``Recording.replay()`` launches the pieces in order on the current stream,
opens and closes the spans between them, and adds each piece's rises: a
replayed step has the spans and the counts of the eager one (every kernel
launch still counts once), and its spans' CUDA events time the graphs.

``GraphedCall(fn, counter)`` serves ``fn(x)`` (x a CUDA tensor, the result
a tuple of tensors) from recordings keyed by x's shape, dtype and device.
The first call of a key runs ``fn`` eagerly, which builds the kernels and
warms the libraries; the second captures, on a copy of x in a buffer of its
own; every call from then on copies x into that buffer, replays, and
returns clones of the outputs, which the caller owns.  At most ``KEEP``
keys are kept, the least recently used evicted.  The tracer's counters
``<counter>.replay``, ``.capture`` and ``.eager`` count the calls served by
a replay, the captures and the calls run eagerly.  A capture that fails
raises, and the next call of its key tries again.  Calls from several
threads are served one at a time, and a call on one stream waits on the
card until the last call of its key, on whatever stream, is done with the
key's buffers.  A recording reads the tensors ``fn`` read where they lived
at capture: parameters updated in place are seen, replaced ones are not.
"""

from __future__ import annotations

import collections
import threading
import warnings
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from . import tracing

__all__ = ["GraphedCall", "Recording", "capture"]

Step = Union["_Piece", Tuple[str, str, Optional[torch.device]]]


class _Piece:
    __slots__ = ("graph", "rise")

    def __init__(self, graph, rise: List[Tuple[str, int]]):
        self.graph, self.rise = graph, rise


class Recording:
    """The captured run of a function (see the module): ``steps`` are the
    graphs and the spans' ("open" | "close", name, device) marks between
    them; ``outputs`` what the function returned."""

    def __init__(self, steps: List[Step], outputs):
        self.steps, self.outputs = steps, outputs

    @property
    def graphs(self) -> int:
        return sum(isinstance(step, _Piece) for step in self.steps)

    def replay(self) -> None:
        opened = []
        for step in self.steps:
            if isinstance(step, _Piece):
                step.graph.replay()
                for name, n in step.rise:
                    tracing.count(name, n)
            elif step[0] == "open":
                s = tracing.span(step[1], step[2])
                s.__enter__()
                opened.append(s)
            else:
                opened.pop().__exit__(None, None, None)


def capture(fn: Callable[[], object], device: torch.device) -> Recording:
    """Capture ``fn()``'s work on ``device`` (see the module).  Raises what
    the capture raised, with no capture left open."""
    pool = torch.cuda.graph_pool_handle()
    here = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(here)
    steps: List[Step] = []
    open_piece = {}
    counts: Dict[str, int] = {}  # this thread's counts since the last cut

    def begin():
        graph = torch.cuda.CUDAGraph()
        # only this thread's unsafe calls break the capture: a stream's
        # pack and upload workers may pin and copy meanwhile
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        open_piece["graph"] = graph

    def end():
        graph = open_piece.pop("graph")
        rise = [(k, n) for k, n in counts.items() if n]
        counts.clear()
        with warnings.catch_warnings():
            # a piece between two marks may hold no work
            warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
            graph.capture_end()
        steps.append(_Piece(graph, rise))

    def cut(kind: str, name: str, where: Optional[torch.device]) -> None:
        end()
        steps.append((kind, name, where))
        begin()

    with torch.cuda.stream(side), tracing.cutting(cut, counts):
        begin()
        try:
            outputs = fn()
        except BaseException:
            if "graph" in open_piece:
                try:
                    end()
                except Exception:  # the capture was broken; the error above says why
                    pass
            raise
        end()
    here.wait_stream(side)
    return Recording(steps, outputs)


class _Entry:
    __slots__ = ("static", "recording", "done")

    def __init__(self, static: torch.Tensor, recording: Recording):
        self.static, self.recording = static, recording
        self.done = torch.cuda.Event()  # recorded after each replay's clones


class GraphedCall:
    """``fn(x)`` served from CUDA graphs (see the module)."""

    KEEP = 4

    def __init__(self, fn: Callable[[torch.Tensor], Tuple[torch.Tensor, ...]], counter: str):
        self._fn = fn
        self._counter = counter
        for kind in ("replay", "capture", "eager"):
            tracing.count(f"{counter}.{kind}", 0)
        self._keys: "collections.OrderedDict[tuple, Optional[_Entry]]" = (
            collections.OrderedDict())
        self._lock = threading.Lock()

    def keys(self) -> List[tuple]:
        """The keys kept, the least recently used first."""
        return list(self._keys)

    def eager(self, x: torch.Tensor):
        """``fn(x)`` run eagerly, counted as such."""
        tracing.count(f"{self._counter}.eager")
        return self._fn(x)

    def __call__(self, x: torch.Tensor):
        with self._lock:
            key = (tuple(x.shape), x.dtype, x.device)
            if key not in self._keys:
                self._keys[key] = None
                while len(self._keys) > self.KEEP:
                    self._keys.popitem(last=False)
                return self.eager(x)
            self._keys.move_to_end(key)
            entry = self._keys[key]
            if entry is None:
                entry = self._keys[key] = self._capture(x)
            stream = torch.cuda.current_stream(x.device)
            stream.wait_event(entry.done)
            entry.static.copy_(x)
            entry.recording.replay()
            out = tuple(t.clone() for t in entry.recording.outputs)
            entry.done.record(stream)
            tracing.count(f"{self._counter}.replay")
            return out

    def _capture(self, x: torch.Tensor) -> _Entry:
        static = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        static.copy_(x)
        recording = capture(lambda: self._fn(static), x.device)
        tracing.count(f"{self._counter}.capture")
        return _Entry(static, recording)
