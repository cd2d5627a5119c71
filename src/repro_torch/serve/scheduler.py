"""Deadline-driven async serving front (the port of the JAX package's
`serve/scheduler.py`; it is framework-free).

`DeadlineScheduler` wraps a `DRService`'s admission queue in an event
loop: every submitted ticket carries an admission timestamp and a
`max_delay_ms` deadline, and a queued group (one model name, or one LM
step stream) flushes when EITHER

  * it fills — queued rows reach `flush_rows` (default: the bucket
    policy's `max_bucket`, the largest batch one device step takes), OR
  * its oldest ticket's deadline expires

— whichever comes first.  That closes the gap where a lone sub-bucket
request could wait forever on a demand-only `flush()`: the paper's
serving constraint is a latency *bound*, so the batching window must be
bounded too.

All time flows through the service's injectable `Clock`
(`repro_torch.serve.clock`): with a `MonotonicClock` the loop thread parks on
a condition until the next deadline; with a `VirtualClock` it parks
until `advance()` moves time.  Tests can also skip the thread entirely
(`start=False`) and pump `poll()` by hand after advancing — fully
deterministic, no sleeps anywhere.

While a `torch.profiler` profile is active the loop's phases are
`repro_torch.obs` spans: `sched.park` (each wait on the clock),
`sched.scan`, `sched.flush`, and the client's `sched.admit`.

    svc = DRService(buckets=BucketPolicy(min_bucket=8, max_bucket=64))
    svc.register("m", model, state)
    with DeadlineScheduler(svc, default_max_delay_ms=5.0) as sched:
        t = sched.submit("m", x)          # flushes within 5 ms, or sooner
        t.wait(); y = t.result()          # if the bucket fills first
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Hashable, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core.execution import Execution
from repro_torch.serve.engine import DRService


class SchedulerClosed(RuntimeError):
    """Submit after shutdown — the loop will never flush this ticket."""


class DeadlineScheduler:
    """Background event loop flushing the service's queue on fill-or-deadline.

    `default_max_delay_ms` is the deadline given to tickets submitted
    without an explicit one, so nothing admitted through the scheduler can
    wait unboundedly.  `flush_rows` is the fill trigger per group key.
    `start=False` builds the scheduler loopless — `poll()` must then be
    driven by the caller (the deterministic test mode).

    `wake_lead_ms` makes a group due that many ms BEFORE its oldest
    deadline: on a real clock the loop's wakeup has OS latency, so a
    flush triggered exactly at the deadline starts epsilon-late and the
    SLO counts it missed — a ~1 ms lead absorbs that.  Default 0 so
    virtual-clock tests stay exact (advance(D - eps) must not flush).
    """

    def __init__(self, service: DRService, *,
                 default_max_delay_ms: float = 10.0,
                 flush_rows: Optional[int] = None,
                 wake_lead_ms: float = 0.0,
                 start: bool = True):
        if default_max_delay_ms < 0:
            raise ValueError("default_max_delay_ms must be >= 0")
        if wake_lead_ms < 0:
            raise ValueError("wake_lead_ms must be >= 0")
        self.service = service
        self.default_max_delay_ms = float(default_max_delay_ms)
        self.wake_lead_ms = float(wake_lead_ms)
        self.flush_rows = int(flush_rows if flush_rows is not None
                              else service.buckets.max_bucket)
        if self.flush_rows < 1:
            raise ValueError("flush_rows must be >= 1")
        self._cond = threading.Condition()
        self._stop = False  # guarded-by: _cond
        self._drain_on_stop = True  # guarded-by: _cond
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # ---- admission ---------------------------------------------------------
    # Every admission holds the loop condition across the open-check AND the
    # enqueue: a submit that passed the check can't interleave with
    # shutdown's final drain and strand a ticket no loop will ever serve.
    def submit(self, name: str, x: torch.Tensor, *,
               max_delay_ms: Optional[float] = None):
        """Admit a DR request; the loop answers it within `max_delay_ms`
        (default `default_max_delay_ms`) or as soon as its bucket fills."""
        with self._cond:
            self._check_open()
            t = self.service.submit(
                name, x, max_delay_ms=self.default_max_delay_ms
                if max_delay_ms is None else max_delay_ms)
            self._cond.notify_all()
        return t

    def submit_step(self, tag: Hashable, kind: str,
                    fn: Callable[..., Any], *args: Any,
                    rows: int = 1, max_delay_ms: Optional[float] = None):
        """Admit a non-DR step (LM prefill/decode) — same deadline rules,
        same queue, same SLO accounting as DR traffic.  While a profile is
        active the ticket carries a request id (`Ticket.req`), shared by
        its `sched.admit` and `serve.step` spans."""
        req = obs.request_id()
        with obs.span("sched.admit", req), self._cond:
            self._check_open()
            t = self.service.submit_step(
                tag, kind, fn, *args, rows=rows,
                max_delay_ms=self.default_max_delay_ms
                if max_delay_ms is None else max_delay_ms)
            t.req = req
            self._cond.notify_all()
        return t

    # The LM helpers build the step (service.prefill_step/decode_step — the
    # shared construction path) BEFORE taking the condition: a compile-cache
    # miss builds under no lock, so it can't stall other submitters or the
    # loop's wakeup path; only the enqueue is serialized.
    def lm_prefill(self, cfg: Any, mesh: Any, params: Any, batch: Any,
                   cache_size: int, *, tag: Hashable = "lm",
                   max_delay_ms: Optional[float] = None,
                   execution: Execution = Execution()):
        fn, rows = self.service.prefill_step(cfg, mesh, params, batch,
                                             cache_size, execution=execution)
        return self.submit_step(tag, "prefill", fn, params, batch,
                                rows=rows, max_delay_ms=max_delay_ms)

    def lm_decode(self, cfg: Any, mesh: Any, params: Any, token: Any,
                  kv_cache: Any, *, tag: Hashable = "lm",
                  max_delay_ms: Optional[float] = None,
                  execution: Execution = Execution()):
        fn, rows = self.service.decode_step(cfg, mesh, params, token,
                                            kv_cache, execution=execution)
        return self.submit_step(tag, "decode", fn, params, token, kv_cache,
                                rows=rows, max_delay_ms=max_delay_ms)

    # ---- the event loop ----------------------------------------------------
    def poll(self) -> int:
        """Flush every group that is due (full, or oldest deadline expired)
        at the clock's current now.  Returns device batches run.  Safe to
        call from any thread, any time — the loop and manual pumping
        compose (a group drains exactly once)."""
        due, _ = self._scan(self.service.clock.now())
        if not due:
            return 0
        with obs.span("sched.flush"):
            return self.service.flush(keys=due)

    def next_deadline(self) -> Optional[float]:
        """Earliest absolute deadline (clock ms) over queued tickets, or
        None when nothing queued carries one."""
        dls = [dl for _, dl in self.service.batcher.pending_by_key().values()
               if dl is not None]
        return min(dls) if dls else None

    def _scan(self, now: float) -> Tuple[List[Hashable], Optional[float]]:
        """One pending_by_key snapshot → (due keys, earliest deadline of
        the NOT-due remainder) — the loop's whole decision in one pass."""
        due: List[Hashable] = []
        nxt: Optional[float] = None
        with obs.span("sched.scan"):
            for k, (rows, dl) in self.service.batcher.pending_by_key().items():
                if rows >= self.flush_rows or \
                        (dl is not None and dl <= now + self.wake_lead_ms):
                    due.append(k)
                elif dl is not None:
                    nxt = dl if nxt is None else min(nxt, dl)
        return due, nxt

    def _run(self) -> None:
        clock = self.service.clock
        while True:
            flushed = self.poll()           # outside the lock: runs compute
            if flushed:
                continue
            with self._cond:
                if self._stop:
                    break
                # re-check under the lock so a submit/advance racing the
                # poll above can't be a lost wakeup
                now = clock.now()
                due, dl = self._scan(now)
                if due:
                    continue
                # park until wake_lead_ms BEFORE the next deadline so
                # the flush starts inside the budget on a real clock
                with obs.span("sched.park"):
                    clock.wait(self._cond, None if dl is None else dl - now - self.wake_lead_ms)
        if self._drain_on_stop:
            self.service.flush()

    # ---- lifecycle ---------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "DeadlineScheduler":
        # Pre-register our condition with clocks that need it (VirtualClock):
        # registering only inside wait() would leave the loop's FIRST park
        # blind to an advance() racing its predicate check.
        register = getattr(self.service.clock, "register", None)
        if register is not None:
            register(self._cond)
        with self._cond:
            if self._stop:
                raise SchedulerClosed("scheduler already shut down")
            if self._thread is not None:
                return self
            self._thread = threading.Thread(
                target=self._run, name="deadline-scheduler", daemon=True)
            self._thread.start()
        return self

    def shutdown(self, *, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the loop.  With `drain=True` (default) every queued ticket
        is flushed on the way out, so shutdown never strands a request;
        with `drain=False` pending tickets stay unresolved."""
        with self._cond:
            if self._stop:
                return
            self._stop = True
            self._drain_on_stop = drain
            self._cond.notify_all()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise RuntimeError("scheduler loop did not stop in time")
        elif drain:
            self.service.flush()

    def __enter__(self) -> "DeadlineScheduler":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.shutdown()

    # ---- internals ---------------------------------------------------------
    def _check_open(self) -> None:
        if self._stop:
            raise SchedulerClosed("scheduler is shut down")
