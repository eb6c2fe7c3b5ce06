"""Spans and counts at the port's layer boundaries, recorded while a
`torch.profiler` session is active and never otherwise.

    with spans.span("stage1.model", rows=256):
        ...
        spans.add(tokens=n)        # onto the innermost open span
    spans.records()                # the finished spans, oldest first
    spans.reset()

A span records its name, its start and end on `time.perf_counter_ns()`
(the clock a benchmark's own host spans read), the index of its parent
span, a request id (the index of the outermost open span of its thread:
every span under one `service.*` or `train.step` call shares it), its
thread and its counts. The open spans are a stack per thread, so ranks
run as threads nest their own spans. Records stay in memory, the newest
`CAPACITY` of them; `dropped()` counts those pushed out, so a reader can
refuse a window that lost records.

The switch is torch's own: `torch.autograd.profiler._is_profiler_enabled`,
set while any profiler session runs. Off, a span site costs that one
check; a count that costs work to compute is computed under
`recording()`. Nothing is written to the profiler's trace: a range
of the profiler's own would leave a shadow on the device's timeline.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

CAPACITY = 1 << 18


class Record(NamedTuple):
    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    request: int
    thread: int
    counts: Dict[str, int]


def recording() -> bool:
    """True while a torch.profiler session is active."""
    return _profiler._is_profiler_enabled


class _Open:
    __slots__ = ("recorder", "index", "name", "start_ns", "parent", "request",
                 "counts")

    def __init__(self, recorder: "Recorder", name: str, counts: dict):
        self.recorder, self.name, self.counts = recorder, name, counts

    def __enter__(self) -> "_Open":
        rec = self.recorder
        stack = rec._stack()
        self.index = next(rec._ids)
        if stack:
            top = stack[-1]
            self.parent, self.request = top.index, top.request
        else:
            self.parent, self.request = None, self.index
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        stack = self.recorder._stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        self.recorder._keep(Record(self.index, self.name, self.start_ns, end,
                                   self.parent, self.request,
                                   threading.get_ident(), self.counts))


class _Off:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class Recorder:
    """Finished spans, the newest `capacity` of them, and a stack of open
    spans per thread."""

    def __init__(self, capacity: int = CAPACITY):
        self._capacity = capacity
        self._local = threading.local()
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._records: "collections.deque[Record]" = collections.deque(
                maxlen=self._capacity)
            self._dropped = 0
            self._ids = itertools.count()

    def _stack(self) -> List[_Open]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, record: Record) -> None:
        with self._lock:
            if len(self._records) == self._capacity:
                self._dropped += 1
            self._records.append(record)

    def span(self, name: str, **counts):
        """A context manager that records `name` with `counts` while a
        profiler session is active, and does nothing otherwise."""
        if not _profiler._is_profiler_enabled:
            return _OFF
        return _Open(self, name, counts)

    def add(self, **counts) -> None:
        """Adds `counts` to the innermost open span of this thread."""
        if not _profiler._is_profiler_enabled:
            return
        stack = self._stack()
        if stack:
            top = stack[-1].counts
            for k, v in counts.items():
                top[k] = top.get(k, 0) + v

    def records(self) -> List[Record]:
        with self._lock:
            return list(self._records)

    def dropped(self) -> int:
        """Records pushed out by newer ones since the last reset."""
        return self._dropped


RECORDER = Recorder()
span = RECORDER.span
add = RECORDER.add
records = RECORDER.records
dropped = RECORDER.dropped
reset = RECORDER.reset
