"""Injectable time source for the serving layer.

Every serving component that reads time (`DRService` SLO accounting, the
`DeadlineScheduler` event loop) takes a `Clock` instead of calling
`time.monotonic()` — production uses `MonotonicClock`, tests use
`VirtualClock` and advance time explicitly.  That makes deadline expiry,
latency histograms, and flush ordering deterministic by construction:
a test never sleeps, it calls `clock.advance(ms)`.

Units are **milliseconds** everywhere (matching `max_delay_ms` on the
request path and the SLO latency reports); `now()` is monotonic and has
no defined epoch.

The only blocking primitive is `wait(cond, timeout_ms)` — how an event
loop parks on a `threading.Condition` until its next deadline:

  * `MonotonicClock.wait` is `cond.wait(timeout)` — real time passes.
  * `VirtualClock.wait` blocks with NO timeout; only `advance()` (which
    bumps the virtual time and notifies every parked condition) or an
    explicit `notify` wakes it.  Virtual time never moves on its own, so
    a loop parked on a virtual clock is exactly as stale as the test
    wants it to be.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """Monotonic millisecond time source + condition-wait primitive."""

    def now(self) -> float:
        """Current time in milliseconds (monotonic, arbitrary epoch)."""
        ...

    def wait(self, cond: threading.Condition,
             timeout_ms: Optional[float]) -> None:
        """Park on `cond` (which the caller must hold) for up to
        `timeout_ms` (None = until notified).  May wake spuriously —
        callers re-check their predicate."""
        ...


class MonotonicClock:
    """Production clock: `time.monotonic`, real waits."""

    def now(self) -> float:
        return time.monotonic() * 1e3

    def wait(self, cond: threading.Condition,
             timeout_ms: Optional[float]) -> None:
        cond.wait(None if timeout_ms is None else max(0.0, timeout_ms) / 1e3)


class VirtualClock:
    """Test clock: time moves only via `advance(ms)`.

    `advance` bumps the virtual time and wakes every condition currently
    (or ever) parked through `wait`, so a scheduler event loop blocked on
    its next deadline re-evaluates against the new time.  The waiter set
    only grows (conditions are tiny and per-scheduler); `advance` notifies
    without holding the clock's own lock, so there is no lock-order cycle
    with waiters registering mid-advance.
    """

    def __init__(self, start_ms: float = 0.0):
        self._now = float(start_ms)
        self._lock = threading.Lock()
        self._waiters: "set[threading.Condition]" = set()

    def now(self) -> float:
        with self._lock:
            return self._now

    def register(self, cond: threading.Condition) -> None:
        """Pre-register a condition an event loop will park on.  A loop
        MUST register before its first predicate check: `wait` also
        self-registers, but only after the caller has read the time — an
        `advance` landing in that window would notify nobody and the
        first park would sleep through it."""
        with self._lock:
            self._waiters.add(cond)

    def advance(self, ms: float) -> float:
        """Move virtual time forward by `ms` (>= 0); returns the new now.
        Wakes every parked waiter so loops re-check their deadlines."""
        if ms < 0:
            raise ValueError(f"cannot advance time backwards ({ms} ms)")
        with self._lock:
            self._now += ms
            new_now = self._now
            waiters = list(self._waiters)
        for cond in waiters:
            with cond:
                cond.notify_all()
        return new_now

    def wait(self, cond: threading.Condition,
             timeout_ms: Optional[float]) -> None:
        # Virtual time ignores the timeout: nothing happens until advance()
        # or an explicit notify — that is the whole point.
        with self._lock:
            self._waiters.add(cond)
        cond.wait()
