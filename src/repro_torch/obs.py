"""Spans at the port's layer boundaries, on while a `torch.profiler` profile is.

`span(name, req=None)` is a context manager.  While no profile is active
(`torch.autograd.profiler._is_profiler_enabled`, the process-wide flag that
`torch.profiler.profile` sets) it is one shared null context: a bool read.
While one is, on any thread, the span opens `torch.profiler.record_function
(name)`, so it lands in the profile's trace on the device trace's clock, and
on closing appends one `Span` to a bounded store in this process (the newest
`CAPACITY`; the oldest are dropped).  There is no other switch: run a
profile around the trainer or the service and the spans appear in its trace
and in `spans()`.

    with torch.profiler.profile(...):
        step(state, batch)
    obs.totals("train.backward")    # (count, wall_ms, off_cpu_ms)

A span's times are `time.time_ns()` (Unix time, the clock the profiler's
chrome trace reads as `ts` + `baseTimeNanoseconds`) and the thread's CPU
time (`time.thread_time_ns()`); wall minus CPU is the time the thread was
off the CPU: waiting on a lock, the interpreter lock, or the device's full
launch queue.  Where the thread CPU clock ticks coarsely (some virtualised
hosts step it by 10 ms), one span's `cpu_ns` is right only to a tick and
may exceed its wall time; `totals` subtracts the sums, over which the
ticks average out.  Nothing is written to disk.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 65536        # spans kept in the store; the oldest are dropped


class Span(NamedTuple):
    """One closed span."""
    index: int              # its number in this process, given as it opened
    name: str
    tid: int                # the thread's native id, as the chrome trace has it
    start_ns: int           # time.time_ns()
    end_ns: int
    cpu_ns: int             # the thread's CPU time over the span (to the clock's tick)
    parent: Optional[int]   # `index` of the span open around it on its thread
    req: Optional[int]      # the request it served (`request_id`), if any


class Totals(NamedTuple):
    count: int
    wall_ms: float
    off_cpu_ms: float       # summed wall − summed CPU (at least 0)


_store: "collections.deque[Span]" = collections.deque(maxlen=CAPACITY)
_seq = itertools.count()
_reqs = itertools.count()
_local = threading.local()
_NULL = contextlib.nullcontext()


def _thread() -> Tuple[List[int], int]:
    """(the indices of the spans open on this thread, innermost last; the
    thread's native id, read once: a system call)."""
    try:
        return _local.stack, _local.tid
    except AttributeError:
        _local.stack, _local.tid = [], threading.get_native_id()
        return _local.stack, _local.tid


class _Span:
    __slots__ = ("name", "req", "index", "parent", "stack", "tid", "fn", "start_ns", "cpu0")

    def __init__(self, name: str, req: Optional[int]):
        self.name, self.req = name, req

    def __enter__(self) -> "_Span":
        self.stack, self.tid = _thread()
        self.parent = self.stack[-1] if self.stack else None
        self.index = next(_seq)
        self.stack.append(self.index)
        # the CPU clock's interval lies inside the wall clock's, and both
        # take in the record_function's own cost
        self.start_ns = time.time_ns()
        self.cpu0 = time.thread_time_ns()
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.fn.__exit__(*exc)
        cpu = time.thread_time_ns() - self.cpu0
        end = time.time_ns()
        self.stack.pop()
        _store.append(Span(self.index, self.name, self.tid, self.start_ns, end, cpu,
                           self.parent, self.req))


def span(name: str, req: Optional[int] = None):
    """A span named `name` around the body while a profile is active; a
    shared null context otherwise.  `req` ties the spans of one request."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, req)


def request_id() -> Optional[int]:
    """A new request id while a profile is active, else None."""
    return next(_reqs) if _profiler._is_profiler_enabled else None


def spans() -> List[Span]:
    """A copy of the store, in the order the spans closed."""
    return list(_store)


def clear() -> None:
    _store.clear()


def totals(name: str) -> Totals:
    """The stored spans named `name`: their count, summed wall ms and
    summed off-CPU ms."""
    hits = [s for s in list(_store) if s.name == name]
    wall = sum(s.end_ns - s.start_ns for s in hits)
    cpu = sum(s.cpu_ns for s in hits)
    return Totals(len(hits), wall / 1e6, max(0, wall - cpu) / 1e6)
