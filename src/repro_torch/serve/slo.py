"""Per-bucket latency SLO accounting for the serving engine.

Two latency distributions per (model name, bucket):

  queue_delay — submit → flush start (time a ticket sat in the admission
                queue; what the deadline scheduler bounds), and
  e2e         — submit → result resolved: the queue delay plus the host's
                time to run the batch.  On the card a ticket resolves once
                its batch's work is enqueued, so for an LM step (whose
                kernels the device may still be running) this is not the
                device's completion.

plus deadline counters: a ticket submitted with `max_delay_ms` is *met*
when its flush STARTS at or before its deadline and *missed* otherwise —
the deadline bounds the batching window (queue delay), not batch
compute, so a deadline-triggered flush that fires on time is met.

`LatencyStats` keeps exact percentiles over a bounded sliding window of
recent samples (plus cumulative count/sum/max that never forget), and a
powers-of-two-millisecond histogram view for dashboards.  All values are
milliseconds, read from the engine's injectable `Clock` — under a
`VirtualClock` the recorded latencies are exact, which is what makes the
histogram tests deterministic.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, Hashable, Optional, Tuple


class LatencyStats:
    """Latency distribution: exact percentiles over a bounded window,
    cumulative counters over everything ever recorded."""

    def __init__(self, window: int = 4096):
        if window < 1:
            raise ValueError("window must be >= 1")
        self._samples: "collections.deque[float]" = collections.deque(maxlen=window)  # guarded-by: _lock
        # one lock per stats object: record() runs on the scheduler loop
        # thread while metrics() readers iterate the window from another
        self._lock = threading.Lock()
        self.count = 0  # guarded-by: _lock
        self.total_ms = 0.0  # guarded-by: _lock
        self.max_ms = 0.0  # guarded-by: _lock

    def record(self, ms: float) -> None:
        ms = float(ms)
        if ms < 0:
            raise ValueError(f"negative latency {ms} ms")
        with self._lock:
            self._samples.append(ms)
            self.count += 1
            self.total_ms += ms
            self.max_ms = max(self.max_ms, ms)

    def _window(self) -> list:
        with self._lock:
            return list(self._samples)

    def percentile(self, p: float) -> Optional[float]:
        """Exact p-th percentile (nearest-rank) over the retained window;
        None when nothing has been recorded."""
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile {p} outside [0, 100]")
        s = sorted(self._window())
        if not s:
            return None
        rank = max(1, -(-len(s) * p // 100))  # ceil(len * p / 100), >= 1
        return s[int(rank) - 1]

    @property
    def mean_ms(self) -> Optional[float]:
        with self._lock:
            return self.total_ms / self.count if self.count else None

    def histogram(self) -> Dict[str, int]:
        """Counts of window samples in powers-of-two ms bins:
        `le_<bound>ms` holds samples in (prev_bound, bound]; the first bin
        starts at 0 and bounds double from 0.25 ms up past the max."""
        out: Dict[str, int] = {}
        samples = self._window()
        if not samples:
            return out
        bounds = [0.25]
        while bounds[-1] < max(samples):
            bounds.append(bounds[-1] * 2)
        lo = 0.0
        for b in bounds:
            n = sum(1 for s in samples if lo < s <= b or (lo == 0.0 and s == 0.0))
            if n:
                out[f"le_{b:g}ms"] = n
            lo = b
        return out

    def summary(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "mean_ms": self.mean_ms,
            "max_ms": self.max_ms if self.count else None,
            "p50_ms": self.percentile(50),
            "p95_ms": self.percentile(95),
            "p99_ms": self.percentile(99),
        }


class BucketSLO:
    """One (name, bucket) cell: the two distributions + deadline counters."""

    def __init__(self, window: int = 4096):
        self.queue_delay = LatencyStats(window)
        self.e2e = LatencyStats(window)
        self.deadline_met = 0
        self.deadline_missed = 0

    @property
    def miss_rate(self) -> Optional[float]:
        n = self.deadline_met + self.deadline_missed
        return self.deadline_missed / n if n else None

    def summary(self) -> Dict[str, Any]:
        return {
            "queue_delay": self.queue_delay.summary(),
            "e2e": self.e2e.summary(),
            "deadline_met": self.deadline_met,
            "deadline_missed": self.deadline_missed,
            "deadline_miss_rate": self.miss_rate,
        }


class SLOTracker:
    """All SLO cells of one engine, keyed (model name, bucket size).

    `bucket` is the compiled batch shape the request's rows pad to (an
    int), or a string tag for non-DR traffic routed through the queue
    (LM "prefill"/"decode" steps).
    """

    def __init__(self, window: int = 4096):
        self._window = window
        self._cells: Dict[Tuple[str, Hashable], BucketSLO] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def cell(self, name: str, bucket: Hashable) -> BucketSLO:
        with self._lock:
            key = (name, bucket)
            c = self._cells.get(key)
            if c is None:
                c = self._cells[key] = BucketSLO(self._window)
            return c

    def record(self, name: str, bucket: Hashable, *,
               queue_delay_ms: float, e2e_ms: float,
               deadline_ok: Optional[bool]) -> None:
        """Record one served ticket; `deadline_ok` is None for tickets
        submitted without a deadline (demand-flushed traffic)."""
        c = self.cell(name, bucket)
        c.queue_delay.record(queue_delay_ms)
        c.e2e.record(e2e_ms)
        if deadline_ok is not None:
            with self._lock:        # int += races lose counts across threads
                if deadline_ok:
                    c.deadline_met += 1
                else:
                    c.deadline_missed += 1

    def deadline_counts(self) -> Tuple[int, int]:
        """(met, missed) summed over every cell."""
        with self._lock:
            cells = list(self._cells.values())
        met = sum(c.deadline_met for c in cells)
        missed = sum(c.deadline_missed for c in cells)
        return met, missed

    def report(self) -> Dict[str, Dict[Hashable, Dict[str, Any]]]:
        """{name: {bucket: summary}} — what `DRService.metrics()['slo']`
        surfaces."""
        with self._lock:
            items = list(self._cells.items())
        out: Dict[str, Dict[Hashable, Dict[str, Any]]] = {}
        for (name, bucket), cell in items:
            out.setdefault(name, {})[bucket] = cell.summary()
        return out
