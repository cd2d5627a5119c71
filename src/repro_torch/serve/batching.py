"""Dynamic micro-batching primitives for the serving engine.

Three pieces, each independently testable, copied from the JAX package's
`serve/batching.py` (they are framework-free):

  BucketPolicy       — maps a ragged request-row count onto a small set of
                       padded batch shapes (powers of two between min and
                       max bucket), so the whole fleet's traffic builds
                       O(log max/min) programs instead of one per client
                       batch size.
  BoundedCompileCache— an LRU over built callables.  On the card each value
                       is a captured CUDA graph that pins its static buffers
                       and its private memory pool, so an unbounded cache
                       leaks device memory — this one evicts, and counts
                       hits/misses/evictions so tests can assert build
                       counts.  The LM serving steps share it.
  MicroBatcher       — an admission queue that coalesces queued requests
                       into bucketed batches with backpressure (bounded
                       queue depth) and padding/queue metrics.

The batcher is transport-agnostic: `submit` returns a `Ticket`, `drain`
hands coalesced `(group_key, rows, tickets)` work items to a runner, and
the runner resolves each ticket with its slice of the batched output.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple


class QueueFull(RuntimeError):
    """Admission queue is at max depth — caller must back off (backpressure)."""


# ---------------------------------------------------------------------------
# bucket policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Powers-of-two padding between `min_bucket` and `max_bucket`.

    `bucket_for(n)` is the compiled batch shape a ragged n-row request pads
    to; requests above `max_bucket` are chunked by the batcher, so
    `max_bucket` is also the largest batch a single device step sees.
    With `exact=True` there is no padding at all — every distinct request
    size compiles its own program (the pre-engine behavior, kept as the
    benchmark baseline).
    """

    min_bucket: int = 8
    max_bucket: int = 1024
    exact: bool = False

    def __post_init__(self):
        if self.min_bucket < 1 or self.max_bucket < self.min_bucket:
            raise ValueError(
                f"need 1 <= min_bucket <= max_bucket, got "
                f"{self.min_bucket}/{self.max_bucket}")

    def bucket_for(self, n: int) -> int:
        if n < 1:
            raise ValueError("bucket_for needs n >= 1")
        if self.exact:
            return min(n, self.max_bucket)
        b = self.min_bucket
        while b < n and b < self.max_bucket:
            b *= 2
        return min(b, self.max_bucket)

    def buckets(self) -> Tuple[int, ...]:
        """All bucket sizes this policy can emit (the compile universe).
        Empty for `exact` policies — their universe is unbounded."""
        if self.exact:
            return ()
        out, b = [], self.min_bucket
        while b < self.max_bucket:
            out.append(b)
            b *= 2
        out.append(self.max_bucket)
        return tuple(out)


EXACT = BucketPolicy(min_bucket=1, max_bucket=1024, exact=True)
"""No-padding policy: one compile per distinct request size."""


# ---------------------------------------------------------------------------
# bounded compile cache
# ---------------------------------------------------------------------------

class BoundedCompileCache:
    """LRU cache over compiled callables with hit/miss/eviction counters.

    Replaces the ad-hoc `functools.lru_cache` serving used to keep per
    (model, mesh, layout) jits in: same O(1) lookup, but eviction actually
    drops the jitted closure (and with it the mesh / executable), and the
    counters let tests pin the compile count of a serving scenario.
    """

    def __init__(self, maxsize: int = 64):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = maxsize
        self._d: "collections.OrderedDict[Hashable, Any]" = collections.OrderedDict()  # guarded-by: _lock
        self._lock = threading.Lock()
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        self.races = 0      # guarded-by: _lock (lost build races, discarded)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._d

    def get_or_build(self, key: Hashable, build: Callable[[], Any]) -> Any:
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
        # build outside the lock (jit tracing can be slow / re-entrant)
        fn = build()
        with self._lock:
            if key not in self._d:
                self.misses += 1
                self._d[key] = fn
                while len(self._d) > self.maxsize:
                    self._d.popitem(last=False)
                    self.evictions += 1
            else:
                # another thread built the same key first: our compile work
                # was real, so this is a MISS (misses == programs actually
                # built), tracked as a race — booking it a hit would make
                # compile-count assertions blind to duplicated trace work
                self.misses += 1
                self.races += 1
            self._d.move_to_end(key)
            return self._d[key]

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    @property
    def compiles(self) -> int:
        """Programs built through this cache (== misses)."""
        return self.misses

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"size": len(self._d), "maxsize": self.maxsize,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "races": self.races}


# ---------------------------------------------------------------------------
# admission queue / coalescing
# ---------------------------------------------------------------------------

class Ticket:
    """Handle for one submitted request; resolved at flush time.

    The engine stamps `submitted_at` (clock ms) at admission; callers that
    want latency bounds set `deadline` (absolute clock ms) — the deadline
    scheduler flushes a bucket when its oldest ticket's deadline expires,
    and the SLO tracker counts a miss when the FLUSH STARTS past it (the
    deadline bounds the batching window, not batch compute).
    `deadline is None` means demand-only: the ticket waits for an explicit
    `flush()` or a full bucket.  `req` is the request id its spans share
    (`repro_torch.obs`), set at admission while a profile is active.
    """

    __slots__ = ("rows", "submitted_at", "deadline", "req",
                 "_result", "_error", "_done", "_event")

    def __init__(self, rows: int, *, submitted_at: Optional[float] = None,
                 deadline: Optional[float] = None):
        self.rows = rows
        self.submitted_at = submitted_at
        self.deadline = deadline
        self.req: Optional[int] = None
        self._result = None
        self._error: Optional[BaseException] = None
        self._done = False
        self._event = threading.Event()

    def _resolve(self, value) -> None:
        self._result, self._done = value, True
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error, self._done = err, True
        self._event.set()

    @property
    def done(self) -> bool:
        return self._done

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block (REAL time, seconds) until resolved; True if it is.  For
        cross-thread handoff from a scheduler loop — deterministic tests
        on a VirtualClock never need a timeout: `advance()` triggers the
        flush that sets the event."""
        return self._event.wait(timeout)

    def result(self):
        if not self._done:
            raise RuntimeError("ticket not served yet — flush() the service")
        if self._error is not None:
            raise self._error
        return self._result


@dataclasses.dataclass
class _Pending:
    key: Hashable
    payload: Any
    ticket: Ticket


class MicroBatcher:
    """Bounded admission queue coalescing ragged requests per group key.

    `submit(key, payload, rows)` enqueues (raising `QueueFull` past
    `max_queue` queued rows — that is the backpressure signal an RPC layer
    would surface as 429/`RESOURCE_EXHAUSTED`); `drain()` pops everything
    and yields `(key, [(payload, ticket), ...])` groups in FIFO order for
    the engine to batch, run, and resolve.
    """

    def __init__(self, max_queue: int = 4096):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.max_queue = max_queue
        self._q: List[_Pending] = []  # guarded-by: _lock
        self._lock = threading.Lock()
        # metrics
        self.submitted = 0  # guarded-by: _lock
        self.served = 0  # guarded-by: _lock
        self.rejected = 0  # guarded-by: _lock
        self.peak_depth = 0  # guarded-by: _lock

    def queue_depth(self) -> int:
        with self._lock:
            return sum(p.ticket.rows for p in self._q)

    def submit(self, key: Hashable, payload: Any, rows: int, *,
               submitted_at: Optional[float] = None,
               deadline: Optional[float] = None) -> Ticket:
        if rows > self.max_queue:
            # NOT QueueFull: even an empty queue can never admit this
            # request, so retrying-on-backoff would spin forever — it is a
            # caller bug, distinct from transient backpressure
            raise ValueError(
                f"request of {rows} rows exceeds max_queue={self.max_queue} "
                f"and can never be admitted — chunk the request (QueueFull "
                f"signals transient backpressure; this does not pass)")
        t = Ticket(rows, submitted_at=submitted_at, deadline=deadline)
        with self._lock:
            depth = sum(p.ticket.rows for p in self._q)
            if depth + rows > self.max_queue:
                self.rejected += 1
                raise QueueFull(
                    f"queue depth {depth}+{rows} exceeds max_queue={self.max_queue}")
            self._q.append(_Pending(key, payload, t))
            self.submitted += 1
            self.peak_depth = max(self.peak_depth, depth + rows)
        return t

    def drain(self, keys: Optional[Sequence[Hashable]] = None,
              ) -> List[Tuple[Hashable, List[Tuple[Any, Ticket]]]]:
        """Pop pending work as `(key, [(payload, ticket), ...])` groups in
        FIFO order.  With `keys`, only those groups drain — everything else
        stays queued (how the deadline scheduler flushes just the buckets
        that are due)."""
        with self._lock:
            if keys is None:
                q, self._q = self._q, []
            else:
                ks = set(keys)
                q = [p for p in self._q if p.key in ks]
                self._q = [p for p in self._q if p.key not in ks]
            self.served += len(q)
        groups: "collections.OrderedDict[Hashable, List[Tuple[Any, Ticket]]]" = \
            collections.OrderedDict()
        for p in q:
            groups.setdefault(p.key, []).append((p.payload, p.ticket))
        return list(groups.items())

    def pending_by_key(self) -> Dict[Hashable, Tuple[int, Optional[float]]]:
        """Snapshot `{key: (queued_rows, earliest_deadline)}` for the
        scheduler's due-check; `earliest_deadline` is None when no queued
        ticket under that key carries one."""
        with self._lock:
            out: Dict[Hashable, Tuple[int, Optional[float]]] = {}
            for p in self._q:
                rows, dl = out.get(p.key, (0, None))
                d = p.ticket.deadline
                if d is not None:
                    dl = d if dl is None else min(dl, d)
                out[p.key] = (rows + p.ticket.rows, dl)
            return out

    def stats(self) -> Dict[str, int]:
        return {"queue_depth": self.queue_depth(), "max_queue": self.max_queue,
                "submitted": self.submitted, "served": self.served,
                "rejected": self.rejected, "peak_depth": self.peak_depth}
