"""Spans and counters inside the program, on the clock of ``torch.profiler``.

A span marks one step of the program (``with span("predict", device): ...``,
or ``@spanned("certify")`` around a whole function) and records:

  * its name, ``lapgnn.<name>``;
  * its own id, its parent's id (the innermost span open on the same thread
    when it opened, None for a root) and a request id, shared by every span
    of one ``solve`` call, one ``solve_stream`` instance or one train step: a
    root takes its own id as its request unless the caller names one;
  * its host start and end as Unix-epoch nanoseconds (``time.time_ns()``),
    the clock on which ``torch.profiler``'s events carry both host and
    device activity, so spans and a device trace line up;
  * with a CUDA ``device``, a pair of CUDA events recorded on that device's
    current stream around the work (read only when ``device_ms`` is asked
    for, so recording adds no sync); host-only spans record none;
  * every counter's value when it opened and when it closed, so that the
    counts of one call are the difference.

While a ``torch.profiler`` session records, each span also opens a
profiler range ``lapgnn.<name>`` (``torch._C._profiler._RecordFunctionFast``,
the C form of ``torch.profiler.record_function``), so it appears, nested, in
the profile.  The span reads its clock and opens or closes the range in one
C step (``_adjacent``), so that no other thread (a ``solve_stream`` worker)
takes the GIL between the two: taking it back can cost the 5 ms switch
interval, and ``record_function`` drops it in its ``torch.ops`` calls.

The tracer records while a ``torch.profiler`` session is recording (on
every thread, though the profiler itself sees only the thread that started
it) or inside ``record()``.  Otherwise ``span`` returns one shared do-nothing
context and ``spanned`` calls the function alone: no range, no event, no
allocation.  Closed spans stay in memory, the newest ``MAX_SPANS`` of them,
until ``take()`` drains them (``recorded()`` reads them in place).

While a CUDA graph is captured on a thread (``cutting``, which
``graphs.capture`` uses), a span opened there records nothing: it tells the
capture where it opens and closes, and the capture cuts its graph there, so
that each replay opens the same spans around the same work; and the
thread's counts are held for the capture, which each replay adds.

Counters are integer adds that always count.  ``host_syncs`` counts each
point where the host waits on the device; the program makes each such copy
through ``to_device``, ``to_host`` or ``item``, which copy and count in one
call.  On the CPU the same call sites count, so that tests can hold the
count.

    with tracing.record():
        pipe.solve(C)
    for s in tracing.take():
        print(s.name, s.host_ms, s.device_ms, s.counts("host_syncs"))
"""

from __future__ import annotations

import collections
import functools
import itertools
import operator
import threading
import time
from contextlib import contextmanager
from typing import Callable, Deque, Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["MAX_SPANS", "Span", "count", "counters", "cutting", "discard", "enabled", "item",
           "mark", "new_request", "record", "recorded", "span", "spanned", "take", "to_device",
           "to_host"]

PREFIX = "lapgnn."
MAX_SPANS = 100_000  # about 100 s of a 2048 solve loop under the profiler

# the profiler's state on the calling thread; ``_autograd_profiler``'s flag
# is the same for every thread of the process
_profiler_enabled = torch._C._autograd._profiler_enabled
_recording = 0  # depth of open ``record()`` blocks
_spans: Deque["Span"] = collections.deque(maxlen=MAX_SPANS)
_spans_lock = threading.Lock()
_counters: Dict[str, int] = {"host_syncs": 0}
_counter_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def _profiling() -> bool:
    return bool(_autograd_profiler._is_profiler_enabled or _profiler_enabled())


def enabled() -> bool:
    """Whether spans record now: inside ``record()`` or while
    ``torch.profiler`` records."""
    return bool(_recording) or _profiling()


@contextmanager
def record() -> Iterator[None]:
    """Record spans inside the block, without the profiler's cost."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


@contextmanager
def cutting(cut: Callable[[str, str, Optional[torch.device]], None],
            counts: Dict[str, int]) -> Iterator[None]:
    """Inside the block, on this thread, each span records nothing and calls
    ``cut("open", name, device)`` where it opens and ``cut("close", name,
    device)`` where it closes (a CUDA graph's capture cuts there), and each
    count adds to ``counts`` instead of the counters (what a capture counts
    has not run yet)."""
    outer = getattr(_local, "cut", None), getattr(_local, "held", None)
    _local.cut, _local.held = cut, counts
    try:
        yield
    finally:
        _local.cut, _local.held = outer


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (to the held counts while
    ``cutting``)."""
    held = getattr(_local, "held", None)
    if held is not None:
        held[name] = held.get(name, 0) + n
        return
    with _counter_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """Every counter's value now."""
    with _counter_lock:
        return dict(_counters)


def to_device(data, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``data`` on ``device``: a host tensor copied there, or numbers made
    there by ``torch.tensor``.  The copy blocks the host: one ``host_syncs``."""
    count("host_syncs")
    if isinstance(data, torch.Tensor):
        return data.to(device)
    return torch.tensor(data, dtype=dtype, device=device)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to the host, after the device's queue: one ``host_syncs``."""
    count("host_syncs")
    return t.cpu()


def item(t: torch.Tensor):
    """``t.item()``, a read of the device by the host: one ``host_syncs``."""
    count("host_syncs")
    return t.item()


def new_request() -> int:
    """A fresh request id, for spans of one unit of work that open on
    several threads (a stream instance)."""
    return next(_ids)


def mark() -> int:
    """An id below that of every span opened from now on (for ``discard``)."""
    return next(_ids)


def recorded() -> List["Span"]:
    """The closed spans recorded so far, oldest closed first."""
    with _spans_lock:
        return list(_spans)


def take() -> List["Span"]:
    """The closed spans recorded so far; the store is emptied."""
    with _spans_lock:
        out = list(_spans)
        _spans.clear()
    return out


def discard(since: int) -> None:
    """Drop the recorded spans opened after ``mark()`` gave ``since``."""
    with _spans_lock:
        kept = [s for s in _spans if s.id < since]
        _spans.clear()
        _spans.extend(kept)


def _adjacent(first: Callable, second: Callable) -> tuple:
    """``(first(), second())`` of two C callables, called from C one after
    the other, so that no other thread takes the GIL between them."""
    return tuple(map(operator.call, (first, second)))


def _stack() -> List["Span"]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One step of the program; a context manager (see the module)."""

    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns", "counts_open",
                 "counts_close", "_device", "_into", "_keep", "_range", "_stream", "_events")

    def __init__(self, name: str, device: Optional[torch.device], request: Optional[int],
                 into: Optional[List["Span"]], keep: bool):
        self.name = PREFIX + name
        self.id = next(_ids)
        self.request = request
        self.parent: Optional[int] = None
        self.start_ns = self.end_ns = 0
        self.counts_open: Dict[str, int] = {}
        self.counts_close: Dict[str, int] = {}
        self._device = device if device is not None and device.type == "cuda" else None
        self._into = into
        self._keep = keep
        self._range = None
        self._stream = None
        self._events = None

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            self.parent = stack[-1].id
            if self.request is None:
                self.request = stack[-1].request
        elif self.request is None:
            self.request = self.id
        stack.append(self)
        if _profiling():
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
        # the host interval holds the profiler's range: its first entry on a
        # thread spends a millisecond after the range's own start time
        if self._range is not None:
            self.start_ns, _ = _adjacent(time.time_ns, self._range.__enter__)
        else:
            self.start_ns = time.time_ns()
        if self._device is not None:
            self._stream = torch.cuda.current_stream(self._device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        self.counts_open = counters()
        return self

    def __exit__(self, *exc) -> bool:
        self.counts_close = counters()
        if self._events is not None:
            self._events[1].record(self._stream)
            self._stream = None
        if self._range is not None:
            _, self.end_ns = _adjacent(functools.partial(self._range.__exit__, *exc), time.time_ns)
        else:
            self.end_ns = time.time_ns()
        self._range = None
        _stack().pop()
        if self._into is not None:
            self._into.append(self)
        if self._keep:
            with _spans_lock:
                _spans.append(self)
        return False

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> Optional[float]:
        """The span's time on the card by its CUDA events (waits for the
        end event); None for a host-only span."""
        if self._events is None:
            return None
        self._events[1].synchronize()
        return self._events[0].elapsed_time(self._events[1])

    @property
    def ms(self) -> float:
        """``device_ms`` where the span has CUDA events, else ``host_ms``."""
        device = self.device_ms
        return self.host_ms if device is None else device

    def counts(self, name: str) -> int:
        """How much the counter ``name`` rose while the span was open."""
        return self.counts_close.get(name, 0) - self.counts_open.get(name, 0)


class _Off:
    """The span of a tracer that does not record."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Cut:
    """A span while ``cutting``: it calls the cut where it opens and closes."""

    __slots__ = ("_cut", "_name", "_device")

    def __init__(self, cut, name: str, device: Optional[torch.device]):
        self._cut, self._name, self._device = cut, name, device

    def __enter__(self) -> None:
        self._cut("open", self._name, self._device)

    def __exit__(self, *exc) -> bool:
        if exc[0] is None:
            self._cut("close", self._name, self._device)
        return False


def span(name: str, device: Optional[torch.device] = None, request: Optional[int] = None,
         into: Optional[List[Span]] = None):
    """A span named ``lapgnn.<name>`` around the block, recorded while the
    tracer records.  ``device``: where the block's work runs (CUDA events
    on a CUDA device); ``request``: its request id, for a root that belongs
    to a request opened elsewhere; ``into``: a list that takes the closed
    span whether or not the tracer records (``SolveStats(timed=True)``).
    While ``cutting``, the span only marks the cut."""
    cut = getattr(_local, "cut", None)
    if cut is not None:
        return _Cut(cut, name, device)
    on = enabled()
    if into is None and not on:
        return _OFF
    return Span(name, device, request, into, on)


def spanned(name: str, device: Optional[Callable[..., torch.device]] = None):
    """Decorate a function so that each call is the span ``lapgnn.<name>``;
    ``device``, given the call's arguments, says where its work runs."""

    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not enabled() and getattr(_local, "cut", None) is None:
                return fn(*args, **kwargs)
            where = device(*args, **kwargs) if device is not None else None
            with span(name, where):
                return fn(*args, **kwargs)

        return traced

    return wrap
