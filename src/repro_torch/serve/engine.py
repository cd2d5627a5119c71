"""`DRService` — the online serving engine for DR models, on one card.

The paper's point is one reconfigurable datapath for BOTH training and
deployment; this is that story at service level.  One `DRService` owns:

  * a model registry (`repro_torch.serve.registry`) — named models,
    versioned states, atomic hot-swap: a retrained state is `push`ed as a
    new version and `promote()`d under a lock, so in-flight requests
    always see one consistent (model, state) pair;
  * dynamic micro-batching (`repro_torch.serve.batching`) — ragged client
    requests coalesce through an admission queue into powers-of-two
    bucketed batch shapes, so the program universe is O(log max_bucket)
    programs per model instead of one per client batch size, all held in
    a bounded LRU compile cache (evicting frees the program);
  * train-while-serve — `serve_and_update` answers a request with the
    LIVE state while streaming the same traffic (a configurable fraction
    of it) through `model.update` into a STAGED state; `promote()` makes
    the staged state live, `rollback()` reverts.  Streaming every block
    through `serve_and_update` then promoting reproduces an offline
    `model.fit` with the same block order — tests pin that equivalence;
  * the Execution fast path — a model registered with
    `Execution(backend="kernel")` serves its bucketed transform through
    the fused project + whiten kernel and folds streamed traffic through
    the ternary-matmul and EASI-update kernels (both via the model's own
    dispatch), with its tiles tuned per (bucket, device) at register time
    (`repro_torch.kernels.autotune`); the winner is cached beside the
    program in the bounded compile cache.

On the card every cached program is a `CapturedProgram`: the bucket's
`transform`, or the fused `transform(live) + update(staged)`, captured once
as one CUDA graph — the port's form of `jax.jit`.  Building one captures
it or raises; nothing falls back to eager execution.  On the CPU (the
tests) the cached value is the plain callable.

Typical use:

    svc = DRService(buckets=BucketPolicy(min_bucket=8, max_bucket=1024))
    svc.register("waveform", model, state)
    y = svc.transform("waveform", x)          # one-shot, bucket-padded

    t1 = svc.submit("waveform", x1)           # ragged micro-batched path
    t2 = svc.submit("waveform", x2)
    svc.flush()
    y1, y2 = t1.result(), t2.result()

    y = svc.serve_and_update("waveform", block)   # train-while-serve
    svc.promote("waveform")                       # retrained state goes live

LM prefill / decode steps go through the same queue (`lm_prefill`,
`lm_decode`), built in the same bounded compile cache as the DR programs
and run eagerly.

`DRService(mesh=...)` serves over a `DeviceMesh`
(`repro_torch.launch.mesh`): each bucket program is
`dr_serve.make_dr_transform`'s step — every rank transforms its DP rows
(on the card through the bucket's captured program) and the answer is
gathered before it is cut to the request's rows.  `register(...,
ensemble=k)` serves a k-member `DREnsemble` state: answers are (k, B, n).
Programs are keyed by config hash AND the device they run on, so one
process serving a config on two cards builds a program for each.

`registry=` takes a `repro_torch.serve.replication.ReplicatedRegistry`, so
register / push / promote go fleet-wide while each host serves from its own
device copy of every version; `data_dir=` runs the service over a solo
durable one (quorum 1, a private `LocalBus`), so a restart with the same
directory restores the whole registry.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from repro_torch import kernels, obs
from repro_torch.core.execution import Execution
from repro_torch.dr.model import ModelState
from repro_torch.dist import sharding as shard_rules
from repro_torch.kernels import autotune
from repro_torch.serve import dr_serve, serve_step
from repro_torch.serve.batching import (BoundedCompileCache, BucketPolicy,
                                        MicroBatcher, Ticket)
from repro_torch.serve.clock import Clock, MonotonicClock
from repro_torch.serve.durability import state_hash
from repro_torch.serve.registry import ModelRegistry, Snapshot
from repro_torch.serve.replication import ReplicatedRegistry
from repro_torch.serve.slo import SLOTracker
from repro_torch.serve.transport import LocalBus

PyTree = Any


def _pad_rows(x: torch.Tensor, bucket: int) -> torch.Tensor:
    pad = bucket - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)


def _dummy_batch(model: Any, rows: int, dtype) -> torch.Tensor:
    """Zeros of a request's shape on the model's device: what a program is
    built (and captured) on."""
    return torch.zeros((rows, model.in_dim), dtype=dtype,
                       device=model.execution.torch_device())


def _device_key(model: Any) -> Tuple[str, Optional[int]]:
    """(device type, index) a model's programs run on; an unindexed CUDA
    device is the current card.  Part of every program key: the config hash
    names the device type only (fleet hosts compare it)."""
    dev = torch.device(model.execution.device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev.type, dev.index


def _batch_rows(batch: PyTree) -> int:
    """Rows of an LM batch: the leading dim of its first leaf in key order
    (`jax.tree.leaves`' order in the reference)."""
    return int(serve_step._tree_sig(batch)[0][1][0])


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _rebuild(tree: Any, leaves) -> Any:
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, leaves) for t in tree)
    return next(leaves)


def _version(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t._version


def needs_reload(t: torch.Tensor, loaded: torch.Tensor, version: int) -> bool:
    """Whether a static buffer last loaded from `loaded`, when that tensor
    was at `version`, must be loaded again from `t`: `t` is another tensor,
    or the same tensor written in place since (its `_version` moved)."""
    return t is not loaded or t._version != version


# One capture at a time in this process: `torch.cuda.graph` synchronises
# the device and empties the allocator's cache before it begins, which must
# not land inside another thread's capture.  Replays are never held up.
_CAPTURE_LOCK = threading.Lock()


class CapturedProgram:
    """`fn(*states, x)` captured once as one CUDA graph.

    The graph reads static buffers: a copy of each state's stage tensors
    and an input buffer of x's shape.  A call copies x in, reloads a
    state's buffers only where the caller's state holds another tensor
    than the one last loaded, or the same tensor written in place since
    (`needs_reload`; so a promote or rollback is a reload, never a
    re-capture), replays, and returns copies of the outputs — the next
    replay overwrites the graph's own output buffers, so nothing handed
    out may alias them.  A call with fewer rows than the buffer (a bucket's
    ragged batch) writes them straight into it over zero padding, and
    every output is cut to those rows: only row-wise programs (a bucket's
    `transform`) are called so.  An output that IS a state buffer (a stage that
    `update` returns unchanged) is handed back as the caller's own tensor.
    Calls from any thread serialise on the program; a call waits on the
    device for the previous call to finish with the buffers, whatever
    stream either runs on.

    The capture runs on a stream of its own with
    `capture_error_mode="thread_local"`, so other threads keep launching
    and replaying while it runs; the scratch the kernels allocate during
    the capture lands in the graph's private memory pool.  One eager call
    on that stream first does the lazy set-up (kernel build and load,
    library handles) outside the capture.  `warmup_launches` and
    `captured_launches` hold what the kernel wrappers counted during that
    call and during the capture — a replay runs no Python, so it counts
    nothing; `replays` counts the calls.
    """

    def __init__(self, fn: Callable[..., Any], states: Sequence[ModelState],
                 x: torch.Tensor):
        dev = x.device
        self._bufs = tuple(tuple(None if s is None else s.detach().clone()
                                 for s in st.stages) for st in states)
        static = tuple(st._replace(stages=bufs) for st, bufs in zip(states, self._bufs))
        self._x = x.detach().clone()
        self._lock = threading.Lock()
        self._dirty = x.shape[0]       # guarded-by: _lock (rows of _x that may be nonzero)
        self._loaded = [tuple(st.stages) for st in states]  # guarded-by: _lock
        self._versions = [tuple(map(_version, st.stages)) for st in states]  # guarded-by: _lock
        self._done: Optional[torch.cuda.Event] = None        # guarded-by: _lock
        self.replays = 0                                     # guarded-by: _lock
        stream = torch.cuda.Stream(dev)
        self.graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK:
            stream.wait_stream(torch.cuda.current_stream(dev))
            before = kernels.launch_counts()
            with torch.cuda.stream(stream):
                fn(*static, self._x)
            warm = kernels.launch_counts()
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                out = fn(*static, self._x)
            after = kernels.launch_counts()
        self.warmup_launches = {k: warm[k] - before[k] for k in warm
                                if warm[k] != before[k]}
        self.captured_launches = {k: after[k] - warm[k] for k in after
                                  if after[k] != warm[k]}
        self._out = out
        where = {id(b): (i, j) for i, bufs in enumerate(self._bufs)
                 for j, b in enumerate(bufs) if b is not None}
        # per output leaf: the (state, stage) buffer it is, or None
        self._out_src = [where.get(id(t)) for t in _leaves(out)]

    def __call__(self, *args: Any) -> Any:
        *states, x = args
        rows = x.shape[0]
        if tuple(x.shape[1:]) != tuple(self._x.shape[1:]) or \
                not 1 <= rows <= self._x.shape[0] or x.dtype != self._x.dtype:
            raise ValueError(
                f"captured program takes x {tuple(self._x.shape)} {self._x.dtype}, "
                f"got {tuple(x.shape)} {x.dtype}")
        if len(states) != len(self._bufs) or any(
                len(st.stages) != len(bufs) for st, bufs in zip(states, self._bufs)):
            raise ValueError("captured program called with states of another structure")
        stream = torch.cuda.current_stream(self._x.device)
        waited = obs.span("dr.lock")      # closed once the lock is held
        waited.__enter__()
        with self._lock:
            waited.__exit__(None, None, None)
            with obs.span("dr.reload"):
                if self._done is not None:
                    stream.wait_event(self._done)
                for i, st in enumerate(states):
                    for t, b, old, ver in zip(st.stages, self._bufs[i], self._loaded[i],
                                              self._versions[i]):
                        if b is not None and needs_reload(t, old, ver):
                            b.copy_(t)
                    self._loaded[i] = tuple(st.stages)
                    self._versions[i] = tuple(map(_version, st.stages))
                self._x[:rows].copy_(x)
                if self._dirty > rows:
                    self._x[rows:self._dirty].zero_()
                self._dirty = rows
            with obs.span("dr.replay"):
                self.graph.replay()
            with obs.span("dr.outputs"):
                ragged = rows < self._x.shape[0]
                outs = iter([(t[:rows] if ragged else t).clone() if src is None
                             else states[src[0]].stages[src[1]]
                             for t, src in zip(_leaves(self._out), self._out_src)])
            self._done = torch.cuda.Event()
            self._done.record(stream)
            self.replays += 1
        return _rebuild(self._out, outs)


@dataclasses.dataclass(frozen=True)
class _StepKey:
    """Queue key for non-DR work (LM prefill/decode steps) — wrapping the
    caller's tag keeps step groups disjoint from DR model names."""
    tag: Hashable
    kind: str


@dataclasses.dataclass
class _StepWork:
    """Queued callable: run at flush, its return value resolves the ticket.
    Steps are admitted (ordering, backpressure, deadlines, SLO accounting)
    but not coalesced — an LM step is already a batch."""
    fn: Callable[..., Any]
    args: Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class StagedExtraction:
    """What a fleet-merge collect pulls out of the engine under the
    per-name train-while-serve lock: the staged chain (None when nothing
    is staged), the state the chain was folded FROM (`staged − chain_base`
    is this host's delta — measured against the chain's own base, so the
    delta stays exactly this host's folds even if the live pointer moved
    under the chain), the registry op seq at extraction time (what the
    merger's carry record and the merge-op log are compared against), and
    how many updates the chain folds.  Extraction CONSUMES the chain:
    from here on the delta lives in the merger's durable carry, and a
    late `serve_and_update` starts a fresh chain from the current live
    state — so delta ownership is never split between engine and merger."""
    staged: Optional[PyTree]
    chain_base: Optional[PyTree]
    seq: int
    updates: int


class DRService:
    """Online serving engine: registry + micro-batching + train-while-serve."""

    def __init__(self, *, mesh: Optional[Any] = None,
                 buckets: BucketPolicy = BucketPolicy(),
                 compile_cache_size: int = 32,
                 max_queue: int = 4096,
                 update_fraction: float = 1.0,
                 clock: Optional[Clock] = None,
                 registry: Optional[Any] = None,
                 data_dir: Optional[str] = None):
        shard_rules.check_mesh(mesh)
        if not 0.0 <= update_fraction <= 1.0:
            raise ValueError("update_fraction must be in [0, 1]")
        self.mesh = mesh
        self.buckets = buckets
        self.clock: Clock = clock if clock is not None else MonotonicClock()
        # `registry` hook: anything with the ModelRegistry surface — e.g. a
        # `repro_torch.serve.replication.ReplicatedRegistry` so this
        # service's register/push/promote go fleet-wide (get() semantics
        # unchanged).  `data_dir` is the single-host durability hook: the
        # service runs over a solo durable ReplicatedRegistry (quorum=1,
        # private bus), so every register/push/promote is WAL'd +
        # snapshotted and a restart with the same data_dir restores the
        # whole registry.  Fleet hosts configure data_dir on their own
        # ReplicatedRegistry instead and pass it via `registry=` — both at
        # once is ambiguous.
        if data_dir is not None:
            if registry is not None:
                raise ValueError(
                    "pass data_dir OR registry, not both — a fleet host "
                    "configures data_dir on its ReplicatedRegistry")
            registry = ReplicatedRegistry(
                LocalBus().attach("solo"), role="leader", quorum=1,
                data_dir=data_dir)
        self.registry = registry if registry is not None else ModelRegistry()
        self.cache = BoundedCompileCache(compile_cache_size)
        self.batcher = MicroBatcher(max_queue=max_queue)
        self.slo = SLOTracker()
        self.update_fraction = update_fraction
        # train-while-serve bookkeeping (per model name).  All three dicts
        # are mutated from caller threads AND read by promote(), so every
        # access goes through the per-name lock (`_tws_lock`): promote's
        # pop → push → promote must be atomic w.r.t. a concurrent
        # serve_and_update, or an update chained onto the pre-promote base
        # lands between the pop and the push and is silently orphaned.
        self._staged: Dict[str, PyTree] = {}        # guarded-by: _tws_guard
        self._accum: Dict[str, float] = {}          # guarded-by: _tws_guard
        self._updates: Dict[str, int] = {}          # guarded-by: _tws_guard
        # (staged object, version) of a push whose promote failed — a retry
        # with the SAME chain re-promotes that version instead of pushing a
        # duplicate (a replicated push re-ships the full state to the fleet)
        self._staged_pushed: Dict[str, Tuple[PyTree, int]] = {}  # guarded-by: _tws_guard
        # fleet-merge bookkeeping: the state each staged chain was folded
        # FROM (set when the chain starts, so a merge round can extract
        # `staged − chain_base` as this host's delta) and how many updates
        # the CURRENT chain folds (`_updates` is the cumulative metrics
        # counter; this one resets per chain and rides the extraction).
        self._staged_from: Dict[str, PyTree] = {}   # guarded-by: _tws_guard
        self._chain_updates: Dict[str, int] = {}    # guarded-by: _tws_guard
        self._tws_guard = threading.Lock()          # guards the lock table
        self._tws_locks: Dict[str, threading.Lock] = {}  # guarded-by: _tws_guard
        # serving metrics — counters are bumped from caller threads AND a
        # DeadlineScheduler loop, so mutations AND reads hold this lock
        self._metrics_lock = threading.Lock()
        self.served_rows = 0                        # guarded-by: _metrics_lock
        self.padded_rows = 0                        # guarded-by: _metrics_lock
        self.batches_run = 0                        # guarded-by: _metrics_lock
        self.autotunes = 0                          # guarded-by: _metrics_lock

    def _tws_lock(self, name: str) -> threading.Lock:
        with self._tws_guard:
            lock = self._tws_locks.get(name)
            if lock is None:
                lock = self._tws_locks[name] = threading.Lock()
            return lock

    # ---- registry facade ---------------------------------------------------
    def register(self, name: str, model: Any, state: PyTree, *,
                 ensemble: Optional[int] = None, replace: bool = False) -> int:
        if ensemble is not None:
            model.ensemble(ensemble).members(state)     # a (k,)-stacked state
        v = self.registry.register(name, model, state, ensemble=ensemble,
                                   replace=replace)
        # Registry-register time is when a kernel model's bucket programs
        # are built and get their tile sweep: build every bucket of the
        # policy now (on the card each one is captured here), keyed by
        # config hash + bucket, so the first real request pays neither the
        # build nor tile regret.  A later promote reuses these entries
        # (same config hash); only an eviction — which drops program AND
        # tiles together — rebuilds.
        exe = getattr(model, "execution", None)
        if (ensemble is None and self.mesh is None and exe is not None
                and getattr(exe, "use_kernel", False)):
            snap = self.registry.get(name)
            for b in self.buckets.buckets():    # empty for EXACT policies
                self._transform_fn(snap, b, exe.dtype)
        return v

    def promote(self, name: str, version: Optional[int] = None) -> int:
        """Make a state version live.  With no explicit `version`, promotes
        the state staged by `serve_and_update` (pushing it as a new
        version first) — the online-retrain hot-swap.  The whole
        pop → push → promote runs under the per-name train-while-serve
        lock, so a concurrent `serve_and_update` either lands before the
        pop (its update is in the promoted state) or after the promote
        (it chains onto the newly-live state) — never in between."""
        with obs.span("dr.promote"), self._tws_lock(name):
            if version is None:
                with self._tws_guard:
                    staged = self._staged.pop(name, None)
                    pushed = self._staged_pushed.pop(name, None)
                    chain_base = self._staged_from.pop(name, None)
                    chain_updates = self._chain_updates.pop(name, None)
                if staged is None:
                    raise RuntimeError(
                        f"nothing staged for {name!r}; run serve_and_update "
                        f"first or pass an explicit version")
                try:
                    if pushed is not None and pushed[0] is staged and \
                            self._pushed_still_valid(name, pushed[1], staged):
                        # this exact chain was already pushed by a promote
                        # that then failed — reuse its version, don't ship
                        # a duplicate state to the registry (or the fleet)
                        version = pushed[1]
                    else:
                        version = self.registry.push(name, staged)
                except Exception:
                    with self._tws_guard:
                        self._staged[name] = staged
                        if chain_base is not None:
                            self._staged_from[name] = chain_base
                        if chain_updates is not None:
                            self._chain_updates[name] = chain_updates
                    raise
                try:
                    result = self.registry.promote(name, version)
                except Exception:
                    # promote can fail after the pop+push (e.g. a replicated
                    # registry aborting on lost quorum) — restore the staged
                    # state so the update chain isn't orphaned, and remember
                    # the pushed version so a retry promotes it instead of
                    # pushing again.  We hold the per-name lock, so nothing
                    # staged in between.
                    with self._tws_guard:
                        self._staged[name] = staged
                        self._staged_pushed[name] = (staged, version)
                        if chain_base is not None:
                            self._staged_from[name] = chain_base
                        if chain_updates is not None:
                            self._chain_updates[name] = chain_updates
                    raise
                return result
            return self.registry.promote(name, version)

    def _pushed_still_valid(self, name: str, version: int,
                            staged: PyTree) -> bool:
        """Is a previously-pushed staged version still safe to re-promote?
        Over a plain registry, always (nothing can unseat a pushed
        version).  Over a replicated registry, ask whether the CURRENT
        leader holds that version with the staged content — after a
        failover the new leader may never have seen the push, or hold
        different bytes under the same version id; re-promoting blind
        would flip the fleet to the wrong state."""
        holds = getattr(self.registry, "holds_content", None)
        if holds is None:
            return True
        return holds(name, version, state_hash(staged))

    def rollback(self, name: str) -> int:
        return self.registry.rollback(name)

    def leader_status(self) -> Dict[str, Any]:
        """Who leads the registry this service mutates through, and at
        what election term.  Over a plain `ModelRegistry` the service IS
        its own (static) leader; a registry that elects one reports it."""
        status = getattr(self.registry, "leader_status", None)
        if status is not None:
            return status()
        return {"host": None, "role": "leader", "leader": None, "term": 0}

    def staged_state(self, name: str) -> Optional[PyTree]:
        with self._tws_guard:
            return self._staged.get(name)

    # ---- fleet-merge hook ----------------------------------------------------
    def extract_staged(self, name: str) -> StagedExtraction:
        """Consume the staged chain for a merge round.  Under the
        per-name train-while-serve lock: pop the chain and its base — the
        delta is now the merger's to account for, and the next
        `serve_and_update` starts a fresh chain from whatever state is
        live by then.  The delta math itself happens in the caller,
        outside every lock."""
        with self._tws_lock(name):
            applied = getattr(self.registry, "applied_seq", None)
            seq = applied(name) if applied is not None else -1
            with self._tws_guard:
                staged = self._staged.pop(name, None)
                base = self._staged_from.pop(name, None)
                updates = self._chain_updates.pop(name, 0)
                self._staged_pushed.pop(name, None)
            return StagedExtraction(staged=staged, chain_base=base,
                                    seq=seq, updates=updates)

    # ---- one-shot serving --------------------------------------------------
    def transform(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Serve one request (B, m) → (B, n) with the live state, padded to
        the bucket shape and run through the bounded compile cache.
        Requests above max_bucket are chunked."""
        with obs.span("dr.transform"):
            snap = self.registry.get(name)
            self._check_request(snap, x)
            return self._serve_rows(snap, x)

    # ---- micro-batched serving ---------------------------------------------
    def submit(self, name: str, x: torch.Tensor, *,
               max_delay_ms: Optional[float] = None) -> Ticket:
        """Enqueue a ragged request; returns a Ticket resolved by `flush`.
        Raises `batching.QueueFull` past max_queue rows (backpressure;
        transient — retry after a flush) and `ValueError` for requests
        larger than max_queue outright (never admittable — chunk them).
        `max_delay_ms` sets the ticket's deadline relative to now — a
        `DeadlineScheduler` wrapping this service flushes the bucket when
        it expires; without one it only bounds the SLO miss accounting."""
        snap = self.registry.get(name)          # fail fast on unknown names
        self._check_request(snap, x)
        now = self.clock.now()
        deadline = None if max_delay_ms is None else now + max_delay_ms
        return self.batcher.submit(name, x, int(x.shape[0]),
                                   submitted_at=now, deadline=deadline)

    def submit_step(self, tag: Hashable, kind: str,
                    fn: Callable[..., Any], *args: Any,
                    rows: int = 1,
                    max_delay_ms: Optional[float] = None) -> Ticket:
        """Admit a non-DR step (an already-batched callable) through the
        SAME queue as DR traffic: it shares backpressure, FIFO ordering,
        deadline scheduling, and SLO accounting (under bucket label
        `kind`).  The ticket resolves with `fn(*args)` at flush time."""
        now = self.clock.now()
        deadline = None if max_delay_ms is None else now + max_delay_ms
        return self.batcher.submit(_StepKey(tag, kind), _StepWork(fn, args),
                                   int(rows), submitted_at=now,
                                   deadline=deadline)

    def flush(self, keys: Optional[Sequence[Hashable]] = None) -> int:
        """Coalesce the queue into bucketed batches, run them, resolve every
        ticket with its own rows.  With `keys`, only those groups flush
        (the deadline scheduler's partial flush).  Returns the number of
        device batches THIS call ran (counted locally — a concurrent
        caller's batches never leak into the return value)."""
        n_batches = 0
        for name, items in self.batcher.drain(keys):
            tickets = [t for _, t in items]
            t_flush = self.clock.now()
            try:
                if isinstance(name, _StepKey):
                    # steps are independent (never coalesced): one failing
                    # step fails only its own ticket, the rest still run
                    for work, t in items:
                        try:
                            with obs.span("serve.step", t.req):
                                out = work.fn(*work.args)
                        except Exception as e:  # noqa: BLE001
                            t._fail(e)
                            continue
                        with self._metrics_lock:
                            self.batches_run += 1
                        n_batches += 1
                        # record BEFORE resolve: a waiter woken by the
                        # ticket must find its sample already counted
                        self._record_slo(str(name.tag), name.kind, t,
                                         t_flush)
                        t._resolve(out)
                    continue
                snap = self.registry.get(name)
                # validate every payload against the FLUSH-TIME snapshot:
                # `register(replace=True)` may have swapped the model since
                # submit, and a stale-shaped request must fail alone with a
                # clear message — not blow up the whole group inside
                # torch.cat with an opaque shape error
                good = []
                for payload, t in items:
                    if payload.ndim != 2 or \
                            payload.shape[-1] != snap.model.in_dim:
                        t._fail(ValueError(
                            f"request shaped {tuple(payload.shape)} no longer "
                            f"matches {name!r} at flush time (model expects "
                            f"(B, {snap.model.in_dim}) — it was replaced "
                            f"after this request was submitted)"))
                    else:
                        good.append((payload, t))
                if not good:
                    continue
                tickets = [t for _, t in good]
                xcat = good[0][0] if len(good) == 1 else \
                    torch.cat([p for p, _ in good], dim=0)
                ycat = self._serve_rows(snap, xcat)
                # _serve_rows consumes max_bucket rows per device batch
                n_batches += -(-xcat.shape[0] // self.buckets.max_bucket)
                off = 0
                for t in tickets:
                    sl = ycat[:, off:off + t.rows] if snap.ensemble \
                        else ycat[off:off + t.rows]
                    off += t.rows
                    self._record_slo(name, self.buckets.bucket_for(t.rows),
                                     t, t_flush)
                    t._resolve(sl)
            except Exception as e:          # noqa: BLE001 — fail the tickets
                for t in tickets:
                    if not t.done:
                        t._fail(e)
        return n_batches

    # ---- LM steps through the same queue ------------------------------------
    # The *_step methods are the single source of truth for how an LM step
    # is constructed (cache key, rows derivation, in-place cache contract);
    # both the direct lm_* methods and the DeadlineScheduler's LM helpers
    # call them, so the two admission paths can't drift apart.  The steps
    # run eagerly (no CUDA graph); with a mesh they are `serve_step`'s
    # meshed steps (params, batch and cache laid out by the sharding rules).
    def prefill_step(self, cfg: Any, mesh: Any, params: PyTree,
                     batch: PyTree, cache_size: int, *,
                     execution: Execution = Execution(),
                     ) -> Tuple[Callable[..., Any], int]:
        """(prefill callable, batch rows) — the callable comes from THIS
        service's bounded compile cache, shared with the DR bucket
        programs."""
        fn = serve_step.make_prefill(cfg, mesh, params, batch, cache_size,
                                     cache=self.cache, execution=execution)
        return fn, _batch_rows(batch)

    def decode_step(self, cfg: Any, mesh: Any, params: PyTree,
                    token: torch.Tensor, kv_cache: PyTree, *,
                    execution: Execution = Execution(),
                    ) -> Tuple[Callable[..., Any], int]:
        """(decode callable, batch rows); the step writes the kv cache in
        place (the reference donates it) — don't reuse the argument after
        the step runs."""
        fn = serve_step.make_decode(cfg, mesh, params, kv_cache,
                                    cache=self.cache, execution=execution)
        return fn, int(token.shape[0])

    def lm_prefill(self, cfg: Any, mesh: Any, params: PyTree, batch: PyTree,
                   cache_size: int, *, tag: Hashable = "lm",
                   max_delay_ms: Optional[float] = None,
                   execution: Execution = Execution()) -> Ticket:
        """Admit one LM prefill through the queue; resolves with
        `(logits, kv_cache)`."""
        fn, rows = self.prefill_step(cfg, mesh, params, batch, cache_size,
                                     execution=execution)
        return self.submit_step(tag, "prefill", fn, params, batch,
                                rows=rows, max_delay_ms=max_delay_ms)

    def lm_decode(self, cfg: Any, mesh: Any, params: PyTree, token: torch.Tensor,
                  kv_cache: PyTree, *, tag: Hashable = "lm",
                  max_delay_ms: Optional[float] = None,
                  execution: Execution = Execution()) -> Ticket:
        """Admit one LM decode step through the queue (same contract as
        `lm_prefill`)."""
        fn, rows = self.decode_step(cfg, mesh, params, token, kv_cache,
                                    execution=execution)
        return self.submit_step(tag, "decode", fn, params, token, kv_cache,
                                rows=rows, max_delay_ms=max_delay_ms)

    # ---- train-while-serve -------------------------------------------------
    def _fused_update_fn(self, snap: Snapshot, x: torch.Tensor):
        """Fetch (or build) the fused transform+update program for this
        (config, batch shape, dtype) — on the card a miss captures it HERE,
        not at first real use.

        Called OUTSIDE the per-name train-while-serve lock on purpose:
        holding `_tws_lock(name)` across a capture would convoy every
        concurrent `serve_and_update`/`promote` for the name behind one
        cold shape (the blocking-under-lock hazard the analysis suite
        flags).  The program closes over the model CONFIG only — live and
        staged states are call arguments.  It returns the staged state's
        new stage tensors; `steps` lives on the host and is advanced by the
        caller, outside any graph."""
        key = ("fused", snap.chash, tuple(x.shape), str(x.dtype), _device_key(snap.model))
        model = snap.model  # close over the config only, never the state
        state = snap.state

        def fused(live, staged, xb):
            return model.transform(live, xb), model.update(staged, xb).stages

        def build():
            return self._program(fused, (state, state),
                                 _dummy_batch(model, x.shape[0], x.dtype))

        return self.cache.get_or_build(key, build)

    def serve_and_update(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Answer `x` with the LIVE state and stream it through
        `model.update` into the STAGED state (every `1/update_fraction`-th
        block on average, deterministically via an accumulator).  The
        staged state chains across calls, so a full stream followed by
        `promote()` equals an offline `fit` with the same block order.

        The update step runs under the per-name train-while-serve lock:
        the snapshot read, the update, and the staged write are one atomic
        step w.r.t. a concurrent `promote()` — updates for the same name
        serialize (they must: staged states chain), different names stream
        in parallel.  The fused program is built BEFORE the lock (see
        `_fused_update_fn`); a `register(replace=True)` racing the
        pre-build is detected by config-hash mismatch under the lock and
        rebuilt there (rare, waived)."""
        with obs.span("dr.serve_and_update"):
            snap0 = self.registry.get(name)
            self._check_request(snap0, x)
            if snap0.ensemble:
                raise NotImplementedError(
                    "train-while-serve targets single models; ensembles are "
                    "serve-only (fit them offline via DREnsemble.fit)")
            with self._tws_guard:
                acc = self._accum.get(name, 0.0) + self.update_fraction
                skip = acc < 1.0 - 1e-9
                self._accum[name] = acc if skip else acc - 1.0
            if skip:                                # no update on this block
                return self._serve_rows(snap0, x)

            fused = self._fused_update_fn(snap0, x)
            with self._tws_lock(name):
                snap = self.registry.get(name)
                if snap.chash != snap0.chash:
                    # a replace raced the pre-build: re-validate and rebuild
                    # for the new config (builds under the lock, which is acceptable:
                    # losing this race is as rare as the replace itself)
                    self._check_request(snap, x)
                    fused = self._fused_update_fn(snap, x)  # analysis: allow(blocking-under-lock)
                with self._tws_guard:
                    staged = self._staged.get(name)
                    if staged is None:
                        # a fresh chain starts here: remember the base it is
                        # folded from, so a merge round can extract the delta
                        staged = snap.state
                        self._staged_from[name] = snap.state
                        self._chain_updates[name] = 0
                y, stages = fused(snap.state, staged, x)
                new_staged = staged._replace(stages=stages, steps=staged.steps + 1)
                with self._tws_guard:
                    self._staged[name] = new_staged
                    self._updates[name] = self._updates.get(name, 0) + 1
                    self._chain_updates[name] = \
                        self._chain_updates.get(name, 0) + 1
            with self._metrics_lock:
                self.served_rows += int(x.shape[0])
                self.batches_run += 1
            return y

    # ---- warmup / metrics --------------------------------------------------
    def warmup(self, name: str, *, dtype=torch.float32,
               buckets: Optional[Sequence[int]] = None) -> int:
        """Build the transform for every bucket shape (or the given subset)
        and drive one dummy batch through each, so the first request pays
        neither the build nor a first call."""
        snap = self.registry.get(name)
        n0 = self.cache.misses
        for b in (buckets if buckets is not None else self.buckets.buckets()):
            fn = self._transform_fn(snap, b, dtype)
            fn(snap.state, _dummy_batch(snap.model, b, dtype))
        return self.cache.misses - n0

    def metrics(self) -> Dict[str, Any]:
        met, missed = self.slo.deadline_counts()
        # counters are written under these locks from caller threads and the
        # scheduler loop — read them the same way, or a report racing a
        # flush returns torn (partially bumped) numbers
        with self._metrics_lock:
            served = self.served_rows
            padded = self.padded_rows
            batches = self.batches_run
            autotunes = self.autotunes
        with self._tws_guard:
            updates = dict(self._updates)
            staged = sorted(self._staged)
        return {
            "served_rows": served,
            "padded_rows": padded,
            "batches_run": batches,
            "autotunes": autotunes,
            "updates_applied": updates,
            "staged": staged,
            "compile_cache": self.cache.stats(),
            "queue": self.batcher.stats(),
            "slo": self.slo.report(),
            "deadline_met": met,
            "deadline_missed": missed,
        }

    # ---- internals ---------------------------------------------------------
    def _record_slo(self, name: str, bucket: Hashable, t: Ticket,
                    t_flush: float) -> None:
        # `bucket` is the ticket's NOMINAL size class (bucket_for(rows)) —
        # a coalesced flush may physically run a larger batch, but keeping
        # attribution per-request gives each size class one stable cell.
        # `deadline_ok` is judged on FLUSH START, not post-compute
        # resolution: max_delay_ms bounds the batching window (how long the
        # queue may hold a request), so a deadline-triggered flush that
        # starts on time IS met — judging on resolution would brand every
        # deadline-expiry flush a miss by construction.  `e2e_ms` ends now,
        # when the batch's work has run on the host: on the card, when its
        # kernels are enqueued, not when the device has finished them.
        if t.submitted_at is None:
            return
        now = self.clock.now()
        self.slo.record(
            name, bucket,
            queue_delay_ms=max(0.0, t_flush - t.submitted_at),
            e2e_ms=max(0.0, now - t.submitted_at),
            deadline_ok=None if t.deadline is None else t_flush <= t.deadline)

    def _check_request(self, snap: Snapshot, x: torch.Tensor) -> None:
        if x.ndim != 2 or x.shape[-1] != snap.model.in_dim:
            raise ValueError(
                f"request for {snap.name!r} must be (B, {snap.model.in_dim}); "
                f"got {tuple(x.shape)}")
        if x.shape[0] < 1:
            raise ValueError("empty request")

    def _program(self, fn: Callable[..., Any], states: Tuple[ModelState, ...],
                 x: torch.Tensor):
        """`fn` as the cached program: captured as a CUDA graph on the card,
        the plain callable on the CPU."""
        if x.device.type == "cuda":
            return CapturedProgram(fn, states, x)
        return fn

    def _transform_fn(self, snap: Snapshot, bucket: int, dtype):
        key = ("transform", snap.chash, snap.ensemble, self.mesh is not None, bucket,
               str(dtype), _device_key(snap.model))
        model = snap.model
        fn = model.ensemble(snap.ensemble).transform if snap.ensemble else model.transform

        def build():
            if self.mesh is not None:
                n_dp = shard_rules.axis_size(self.mesh, shard_rules.batch_axes(self.mesh))
                rows = bucket // n_dp if shard_rules.splits_rows(bucket, self.mesh) else bucket
                local = self._program(fn, (snap.state,), _dummy_batch(model, rows, dtype))
                return dr_serve.make_dr_transform(model, self.mesh, batch_size=bucket,
                                                  ensemble=snap.ensemble, local=local)
            if snap.ensemble is None and model.execution.use_kernel:
                return self._tuned_transform(model, snap.state, bucket, dtype)
            return self._program(fn, (snap.state,), _dummy_batch(model, bucket, dtype))

        return self.cache.get_or_build(key, build)

    def _tuned_transform(self, model: Any, state: PyTree, bucket: int, dtype):
        """Race the tile templates for this (bucket, device) and return the
        winning bucket program.  The returned `TunedProgram` carries the
        winning `TileConfig` and every candidate's time alongside the
        program, and it is THE value cached under the transform key — a
        promote (same config hash) hits the cache and never re-tunes, an
        eviction drops the program and its tiles in one step, and a
        post-eviction rebuild runs the race again.  The race times each
        candidate's captured program on the card's clock; the service's
        clock says whether time passes (`autotune.tune`)."""
        exe = model.execution
        # the leading matmul's dims bound the effective tile shapes; the
        # policy's own tiles race first so a hand-tiled Execution wins ties
        cands = autotune.candidates(
            bucket, model.stages[0].out_dim, model.in_dim,
            first=autotune.TileConfig(exe.tmm_block_m, exe.tmm_block_p,
                                      exe.tmm_block_k))
        x0 = _dummy_batch(model, bucket, dtype)

        def build_candidate(tiles: autotune.TileConfig):
            exe2 = dataclasses.replace(
                exe, tmm_block_m=tiles.block_m, tmm_block_p=tiles.block_p,
                tmm_block_k=tiles.block_k)
            return self._program(model.with_execution(exe2).transform,
                                 (state,), x0)

        prog = autotune.tune(cands, build_candidate, (state, x0), timer=self.clock.now)
        with self._metrics_lock:
            self.autotunes += 1
        return prog

    def _serve_rows(self, snap: Snapshot, x: torch.Tensor) -> torch.Tensor:
        """Run (R, m) rows through bucketed batches; returns (R, n) rows in
        order ((k, R, n) for ensembles)."""
        outs = []
        i, step = 0, self.buckets.max_bucket
        while i < x.shape[0]:
            chunk = x[i:i + step]
            rows = chunk.shape[0]
            bucket = self.buckets.bucket_for(rows)
            fn = self._transform_fn(snap, bucket, x.dtype)
            if chunk.device.type == "cuda" and self.mesh is None and not snap.ensemble:
                # a captured row-wise program: it pads into its own input buffer
                y = fn(snap.state, chunk)
            else:
                # a meshed answer is gathered whole before its rows are cut
                y = shard_rules.full(fn(snap.state, _pad_rows(chunk, bucket)))
                y = y[:, :rows] if snap.ensemble else y[:rows]
            outs.append(y)
            with self._metrics_lock:
                self.padded_rows += bucket - rows
                self.served_rows += rows
                self.batches_run += 1
            i += rows
        if len(outs) == 1:
            return outs[0]
        return torch.cat(outs, dim=1 if snap.ensemble else 0)
