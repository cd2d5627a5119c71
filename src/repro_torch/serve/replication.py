"""Cross-host registry replication with atomic fleet-wide promote.

A serving *fleet* must hot-swap models together: if every host promotes
independently, a retrained state goes live on one host while its
neighbors still answer with the old version — the torn deployment this
module exists to prevent.  `ReplicatedRegistry` wraps one unchanged
`ModelRegistry` per host and keeps a fleet of them convergent:

  * **Op log** — every mutation (`register`/`push`/`promote`/`rollback`)
    is an idempotent, per-name sequence-numbered `Op` record.  State
    payloads are content-addressed by `state_hash`, so replaying an op is
    safe (a seq already applied is skipped) and catch-up never re-ships a
    state a host already holds.
  * **Leader/follower** — one leader accepts mutations and replicates
    them; followers apply ops and serve reads from their local registry
    (`get()` keeps the exact snapshot semantics `DRService` relies on).
    A follower that receives an op out of order pulls the gap from the
    leader before acking (anti-entropy inline), and `sync()` performs the
    same catch-up wholesale — how a late-joining host converges.
  * **Two-phase promote** — `promote` first asks every reachable host to
    confirm it *holds* the target version (phase 1, `prepare`; a host
    missing it catches up before confirming).  Only when a configurable
    quorum (default: majority of the fleet) has confirmed does the leader
    append the promote op, flip its own live pointer, and broadcast the
    flip (phase 2, `commit`).  Until phase 2, no live pointer anywhere
    has moved, so an aborted promote (no quorum) leaves the whole fleet
    uniformly on the old version; after `promote()` returns, every host
    that acked is uniformly on the new one, and partitioned stragglers
    converge through anti-entropy when they heal.

Wiring into serving is one constructor hook:

    bus = LocalBus()
    leader = ReplicatedRegistry(bus.attach("h0"), role="leader")
    f1 = ReplicatedRegistry(bus.attach("h1"), role="follower", leader="h0")
    svc0 = DRService(registry=leader)       # mutations go fleet-wide
    svc1 = DRService(registry=f1)           # read replica, same API

Leadership is STATIC by default (followers are read replicas, mutating
one raises).  Attach a `repro_torch.serve.election.Elector` per host and it
becomes dynamic: the fleet elects a new leader when the current one dies,
every replication RPC carries the election `term` so stale (deposed)
leaders are fenced mid-mutation, and mutations issued on a non-leader host
forward to whoever currently leads.

Where states lie.  The op log, the content store (`_states`), the WAL, the
blobs and every message hold host copies (`host_state`): that is what
crosses a transport and what lands on disk.  The state a host's
`DRService` reads through `get()` lies on the model's device
(`model.execution.torch_device()`): each version gets its device copy
ONCE, when it is installed in the local registry (register, push, merge —
replicated or replayed), and `get()` hands back those same tensor objects
every time, so a captured program reloads its buffers only when the live
version changes.  `steps` stays the host counter `ModelState` keeps.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as tree_mod
from repro_torch.dr.model import ModelState
from repro_torch.serve.durability import (CorruptBlobError, DurableStore,
                                          host_state, state_hash)
from repro_torch.serve.registry import (ModelRegistry, Snapshot,
                                        model_config_hash)
from repro_torch.serve.transport import Message, Transport, TransportError

# content addressing (`host_state` / `state_hash`) lives in
# `repro_torch.serve.durability` — the storage layer owns it — and is
# re-exported here, as the reference does.
__all__ = ["Op", "ReplicatedRegistry", "ReplicationError",
           "host_state", "state_hash"]

PyTree = Any


class ReplicationError(RuntimeError):
    """A fleet mutation could not reach its quorum / role contract."""


class _Fenced(ReplicationError):
    """Internal: a message's term went stale between the handler's gate
    and the apply — reply with a fenced nack, not a sync request."""


def _installed(model: Any, st: PyTree) -> PyTree:
    """The copy of host state `st` a host serves: its tensors on `model`'s
    device (a `ModelState`'s `steps` stays the host counter), never sharing
    memory with `st`.  Made once per installed version; a model without an
    `execution` serves the host copy itself, as the reference does."""
    exe = getattr(model, "execution", None)
    if exe is None:
        return st
    dev = exe.torch_device()

    def place(t):
        return t.to(dev, copy=True) if isinstance(t, torch.Tensor) else t

    if isinstance(st, ModelState):
        return ModelState(stages=tree_mod.tree_map(place, st.stages),
                          steps=st.steps.clone(), trainable=st.trainable)
    return tree_mod.tree_map(place, st)


# ---------------------------------------------------------------------------
# op log records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Op:
    """One idempotent, per-name sequence-numbered registry mutation.

    `seq` orders ops within a name (0-based, no gaps); applying the same
    seq twice is a no-op, so delivery may be at-least-once.  `version` is
    the version id the op creates (`register`/`push`) or targets
    (`promote`); `state_hash` content-addresses the payload so catch-up
    can skip states the receiver already holds.  `model` rides along on
    `register` ops only (configs are small; states are the heavy part).
    """

    seq: int
    kind: str                   # register | push | promote | rollback | merge
    name: str
    version: Optional[int] = None
    state_hash: Optional[str] = None
    chash: Optional[str] = None         # register: config identity
    ensemble: Optional[int] = None
    replace: bool = False
    model: Any = None
    # "merge" ops only: the host ids whose staged deltas this version
    # folds in.  A host that missed the merge-commit message consults the
    # op log for a merge op naming it — the durable, anti-entropy-healed
    # signal that its extracted delta actually landed.
    contributors: Tuple[str, ...] = ()
    # the election term of the leader that created this op (0 in static
    # fleets).  Two logs that agree on (seq, term) prefixes agree on
    # content — how anti-entropy detects a deposed leader's uncommitted
    # suffix and how voters compare log freshness (term before length).
    term: int = 0


# ---------------------------------------------------------------------------
# replicated registry
# ---------------------------------------------------------------------------

class ReplicatedRegistry:
    """A `ModelRegistry` that replicates its mutations across a fleet.

    Reads (`get`, `state`, `names`, ...) delegate straight to the wrapped
    local registry — same lock, same snapshot semantics — so `DRService`
    plugs in via its `registry=` hook with no behavior change on the
    request path.  Mutations are leader-only: followers raise
    `ReplicationError` (retrain on the leader; replicas serve).

    `quorum` is the number of hosts (leader included) that must hold a
    version before `promote` flips it live fleet-wide; `None` means a
    majority of the currently-attached fleet, evaluated per call.

    `data_dir` turns on durability (`repro_torch.serve.durability`): every
    committed op, term bump, and vote grant is WAL'd + fsync'd before the
    fleet sees an ack, state payloads land in a content-addressed blob
    store, and construction BOOTSTRAPS from disk — restore the newest
    snapshot, replay the WAL suffix (torn tails truncated, never
    replayed), re-adopt the persisted election term and voted-for map —
    before the transport handler goes live, then `sync_on_start` /
    `join()` heals anything newer from the fleet via the ordinary
    anti-entropy path.
    """

    def __init__(self, transport: Transport, *, role: str = "follower",
                 leader: Optional[str] = None, quorum: Optional[int] = None,
                 sync_on_start: bool = True, data_dir: Optional[str] = None,
                 fsync: bool = True, compact_every: int = 256):
        if role not in ("leader", "follower"):
            raise ValueError(f"role must be leader|follower, got {role!r}")
        if role == "follower" and leader is None:
            raise ValueError("a follower needs its leader's host id")
        if quorum is not None and quorum < 1:
            raise ValueError("quorum must be >= 1")
        self.transport = transport
        self.role = role  # guarded-by: _meta
        self.leader = transport.host_id if role == "leader" else leader  # guarded-by: _meta
        self.quorum = quorum
        self.local = ModelRegistry()
        # election state: `term` is the fencing epoch every replication RPC
        # carries (static fleets stay at 0 forever — no fencing triggers);
        # `elector` is attached by `repro_torch.serve.election.Elector` and turns
        # on dynamic roles + forwarding of mutations to the current leader.
        self.term = 0  # guarded-by: _meta
        self.elector: Optional[Any] = None
        # `merger` is attached by `repro_torch.serve.fleet_merge.FleetMerger`:
        # merge_collect / merge_commit messages dispatch to it (term-fenced
        # by `_check_term` like every other leader-originated RPC).
        self.merger: Optional[Any] = None
        # `_mutate` serializes whole leader mutations (append + broadcast +
        # quorum wait).  `_meta` guards the log/state-store/applied maps and
        # is never held across transport I/O, so pull/status handlers from
        # peers can always be answered while a broadcast is in flight —
        # holding one lock across both is how a TCP fleet deadlocks.
        self._mutate = threading.RLock()  # coarse-lock: append+broadcast+quorum serialize by design
        self._meta = threading.RLock()
        self._log: Dict[str, List[Op]] = {}  # guarded-by: _meta
        self._applied: Dict[str, int] = {}  # guarded-by: _meta (name -> last applied seq)
        self._states: Dict[str, PyTree] = {}  # guarded-by: _meta (content hash -> state)
        self._vhash: Dict[str, List[str]] = {}  # guarded-by: _meta (name -> version -> hash)
        # durability: `_voted` is the persisted term->candidate vote map
        # (the elector reads it back on attach so a restarted host never
        # double-votes); `_recovering` suppresses WAL re-writes while the
        # recovery replay runs ops through the normal `_apply` path.
        self.durable: Optional[DurableStore] = None
        self._voted: Dict[int, str] = {}  # guarded-by: _meta
        # newest fleet-merge error-feedback tree per name (host leaves),
        # mirrored here so compaction snapshots carry it and a restarted
        # merger can seed from `recovered_residuals()`
        self._residuals: Dict[str, PyTree] = {}  # guarded-by: _meta
        self._recovering = False  # guarded-by: _meta
        if data_dir is not None:
            self.durable = DurableStore(data_dir, fsync=fsync,
                                        compact_every=compact_every)
            self._bootstrap()
        transport.set_handler(self._handle)
        if role == "follower" and sync_on_start:
            try:
                self.sync()
            except TransportError:
                pass                                # leader not up yet

    # ---- reads: the wrapped registry, unchanged ---------------------------
    def get(self, name: str) -> Snapshot:
        return self.local.get(name)

    def state(self, name: str, version: int) -> PyTree:
        return self.local.state(name, version)

    def names(self) -> Tuple[str, ...]:
        return self.local.names()

    def __contains__(self, name: str) -> bool:
        return name in self.local

    def n_versions(self, name: str) -> int:
        return self.local.n_versions(name)

    # ---- election hooks ----------------------------------------------------
    def attach_elector(self, elector: Any) -> None:
        """Wire a `repro_torch.serve.election.Elector` in: vote/heartbeat messages
        dispatch to it, and mutations on a non-leader host forward to the
        current leader instead of raising (the static-fleet contract)."""
        self.elector = elector

    def attach_merger(self, merger: Any) -> None:
        """Wire a `repro_torch.serve.fleet_merge.FleetMerger` in: merge_collect /
        merge_commit messages dispatch to it.  Like `attach_elector`, the
        merger is per-host — every host in a merging fleet attaches one."""
        self.merger = merger

    def leader_status(self) -> Dict[str, Any]:
        """Who this host believes leads the fleet, and at what term."""
        with self._meta:
            return {"host": self.transport.host_id, "role": self.role,
                    "leader": self.leader, "term": self.term}

    def observe_term(self, term: int, leader: Optional[str] = None) -> None:
        """Adopt a term observed from the fleet.  A higher term always wins:
        a leader seeing one is DEPOSED (steps down to follower).  `leader`
        names the peer asserting leadership at that term (an op/heartbeat
        sender), or None for a bare term (a vote exchange)."""
        me = self.transport.host_id
        with self._meta:
            if term < self.term:
                return
            if term > self.term:
                self.term = term
                self._persist_term()
                if self.role == "leader":
                    self.role = "follower"
                    self.leader = None
            if leader is not None and leader != me:
                self.leader = leader
                if self.role == "leader":
                    # a same-term usurper is impossible under vote safety,
                    # but never let two leaders coexist
                    self.role = "follower"

    def start_candidacy(self) -> int:
        """Bump the fencing term for a fresh election round and return the
        new term.  The candidate votes for a leader yet to be chosen, so
        the leader pointer clears; a leader campaigning against itself
        (possible after a quorum=1 self-flip) demotes to follower.  Keeps
        every term transition inside this class, same as `observe_term` /
        `become_leader`."""
        with self._meta:
            self.term += 1
            self._persist_term()
            if self.role == "leader":
                self.role = "follower"
            self.leader = None
            return self.term

    def become_leader(self, term: int) -> bool:
        """Flip this host to leader at `term` (an election win).  Returns
        False if a higher term was adopted in the meantime — the win is
        stale and MUST be abandoned."""
        with self._meta:
            if term < self.term:
                return False
            if term > self.term:
                self.term = term
                self._persist_term()
            self.role = "leader"
            self.leader = self.transport.host_id
            return True

    def log_summary(self) -> Dict[str, Tuple[int, int]]:
        """Per-name (last op term, last op seq) — the freshness fingerprint
        a candidate sends with its vote request.  A voter only grants to a
        candidate whose log is at least as fresh as its own on EVERY name,
        comparing (term, seq) lexicographically, so an elected leader can
        never rewind quorum-committed history."""
        with self._meta:
            return {n: (log[-1].term, log[-1].seq)
                    for n, log in self._log.items() if log}

    # ---- durability --------------------------------------------------------
    def _bootstrap(self) -> None:
        """Crash recovery: replay the (snapshot ∘ WAL) op history through
        the normal `_apply` path — so recovery and replication can never
        disagree about what an op does — and re-adopt the persisted
        election term + voted-for map.  An op whose payload blob is
        missing or corrupt ends that name's replay early (the suffix is
        treated like ops this host never received; `join()`'s
        anti-entropy re-pulls it from the fleet)."""
        rec = self.durable.recover()
        # `_meta` is uncontended here (the transport handler isn't wired
        # yet), but these fields are lock-guarded everywhere else and the
        # recovery replay below re-enters `_meta` through `_apply` anyway —
        # an RLock makes holding it here free, and keeps the guarded-by
        # discipline unconditional instead of "except during bootstrap".
        with self._meta:
            self._voted = dict(rec.voted)
            self._residuals = dict(rec.residuals)
            self.term = max(self.term, rec.term)
            self._recovering = True
        try:
            for name, ops in rec.ops.items():
                for op in ops:
                    payloads: Dict[str, PyTree] = {}
                    if op.state_hash is not None and \
                            op.state_hash not in self._states:
                        try:
                            payloads[op.state_hash] = \
                                self.durable.blobs.get(op.state_hash)
                        except (KeyError, CorruptBlobError):
                            break
                    try:
                        self._apply(op, payloads)
                    except ReplicationError:
                        break           # local divergence: let sync() heal
        finally:
            with self._meta:
                self._recovering = False

    def _persist_term(self) -> None:
        """WAL the current term (caller holds `_meta`; no-op when not
        durable or during recovery replay)."""
        if self.durable is not None and not self._recovering:
            self.durable.log_term(self.term)  # analysis: allow(blocking-under-lock)

    def persist_vote(self, term: int, candidate: str) -> None:
        """Record that this host's term-`term` vote went to `candidate` —
        fsync'd BEFORE the grant is answered, so a restarted host can
        never hand the same term's vote to a second candidate (the
        double-vote that elects two leaders at one term)."""
        with self._meta:
            self._voted[int(term)] = candidate
            if self.durable is not None and not self._recovering:
                self.durable.log_vote(int(term), candidate)  # analysis: allow(blocking-under-lock)

    def recovered_votes(self) -> Dict[int, str]:
        """The persisted term->candidate vote map (empty when not durable
        or never voted) — the elector seeds its grant table from this."""
        with self._meta:
            return dict(self._voted)

    def persist_residual(self, name: str, ef: PyTree) -> None:
        """Record this host's fleet-merge carry record for `name` —
        fsync'd BEFORE the sketch is acked to the merge leader, so a host
        that crashes between the WAL append and the ack restarts with the
        exact record it committed to, and the merger resolves its pending
        flag against the merge-op log (`merge_landed`) on the next
        collect (re-resolving is idempotent: last write wins per name).
        The WAL append happens OUTSIDE `_meta` on purpose: residuals have
        no ordering constraint against the op log, and durable I/O under
        a non-coarse lock is exactly what `blocking-under-lock` flags."""
        st = host_state(ef)
        with self._meta:
            self._residuals[name] = st
            recovering = self._recovering
        if self.durable is not None and not recovering:
            self.durable.log_residual(name, st)

    def recovered_residuals(self) -> Dict[str, PyTree]:
        """Per-name error-feedback trees as persisted (empty when not
        durable or never merged) — the merger seeds from this on attach."""
        with self._meta:
            return dict(self._residuals)

    def compact(self) -> None:
        """Fold the WAL into a fresh snapshot now (also triggered
        automatically every `compact_every` WAL appends).  No-op without
        `data_dir`."""
        if self.durable is None:
            return
        with self._meta:
            self.durable.compact(self._durable_dump())  # analysis: allow(blocking-under-lock)

    def _durable_dump(self) -> Dict[str, Any]:
        """Everything a snapshot must hold (caller holds `_meta`)."""
        return {"ops": {n: list(log) for n, log in self._log.items()},
                "term": self.term, "voted": dict(self._voted),
                "residuals": dict(self._residuals)}

    def durability_stats(self) -> Optional[Dict[str, Any]]:
        return None if self.durable is None else self.durable.stats()

    # ---- fleet introspection ----------------------------------------------
    def applied_seq(self, name: str) -> int:
        with self._meta:
            return self._applied.get(name, -1)

    def status(self) -> Dict[str, Any]:
        """Local view: live version + applied seq per name, held hashes."""
        with self._meta:
            names = dict(self._applied)
            hashes = len(self._states)
        return {
            "host": self.transport.host_id,
            "role": self.role,
            "live": {n: self.local.live_version(n) for n in names},
            "applied": names,
            "hashes": hashes,
        }

    def fleet_status(self) -> Dict[str, Dict[str, Any]]:
        """Leader helper: `status()` of every reachable host (self included);
        unreachable peers are omitted."""
        out = {self.transport.host_id: self.status()}
        for p in self.transport.peers():
            try:
                out[p] = self.transport.send(p, {"req": "status"})
            except TransportError:
                pass
        return out

    # ---- mutations (leader only; non-leaders forward when elections are on)
    def register(self, name: str, model: Any, state: PyTree, *,
                 ensemble: Optional[int] = None, replace: bool = False) -> int:
        if self.role != "leader":
            return self._forward("register", name=name, model=model,
                                 state=host_state(state), ensemble=ensemble,
                                 replace=replace)
        st = host_state(state)
        h = state_hash(st)
        with self._mutate:
            with self._meta:
                # validate against the local registry FIRST — a refused
                # register (config-hash conflict) must not enter the log
                self.local.register(name, model, _installed(model, st),
                                    ensemble=ensemble, replace=replace)
                op = Op(seq=self._applied.get(name, -1) + 1, kind="register",
                        name=name, version=0, state_hash=h,
                        chash=model_config_hash(model), ensemble=ensemble,
                        replace=replace, model=model, term=self.term)
                self._commit_meta(op, st)
            self._broadcast(op, {h: st})
            return 0

    def push(self, name: str, state: PyTree) -> int:
        """Append a state version fleet-wide (not live); returns its id."""
        if self.role != "leader":
            return self._forward("push", name=name, state=host_state(state))
        st = host_state(state)
        h = state_hash(st)
        with self._mutate:
            with self._meta:
                version = self.local.push(
                    name, _installed(self.local.get(name).model, st))
                op = Op(seq=self._applied.get(name, -1) + 1, kind="push",
                        name=name, version=version, state_hash=h,
                        term=self.term)
                self._commit_meta(op, st)
            self._broadcast(op, {h: st})
            return version

    def push_merged(self, name: str, state: PyTree, *,
                    contributors: Tuple[str, ...] = ()) -> int:
        """Append a fleet-merge result as a new state version (op kind
        "merge": applied exactly like a push, but the log durably records
        WHICH hosts' staged deltas the version folds in — a contributor
        that missed the merge-commit message finds itself named here and
        reconciles from the op log instead of double-counting its delta)."""
        if self.role != "leader":
            return self._forward("push_merged", name=name,
                                 state=host_state(state),
                                 contributors=tuple(contributors))
        st = host_state(state)
        h = state_hash(st)
        with self._mutate:
            with self._meta:
                version = self.local.push(
                    name, _installed(self.local.get(name).model, st))
                op = Op(seq=self._applied.get(name, -1) + 1, kind="merge",
                        name=name, version=version, state_hash=h,
                        term=self.term, contributors=tuple(contributors))
                self._commit_meta(op, st)
            self._broadcast(op, {h: st})
            return version

    def version_hash(self, name: str, version: int) -> Optional[str]:
        """Content hash this host holds for (`name`, `version`), or None —
        how a merge leader names the base its round's deltas are measured
        against, and how contributors verify they sit on that base."""
        with self._meta:
            vh = self._vhash.get(name, [])
            return vh[version] if 0 <= version < len(vh) else None

    def merge_landed(self, name: str, seq: int, host: str) -> bool:
        """Did a merge op newer than `seq` BOTH name `host` as a
        contributor AND get promoted live?  The durable answer to "was my
        sketch installed" — a host resolves its pending carry record with
        this at collect time when the round's commit message never
        arrived (leader crash, dropped send).  Requiring a later promote
        op for the merge's version matters: a `push_merged` whose quorum
        promote then aborted leaves a merge op in the log but never moved
        any live pointer, and finalizing the carry on it would silently
        drop the un-installed signal.  (A later operator `rollback` of a
        promoted merge is out of scope — error feedback accounts for
        compression loss, not for history rewrites.)"""
        with self._meta:
            log = self._log.get(name, [])
            promoted = {op.version for op in log if op.kind == "promote"}
            for op in reversed(log):
                if op.seq <= seq:
                    return False
                if op.kind == "merge" and host in op.contributors \
                        and op.version in promoted:
                    return True
            return False

    def fence_if_stale(self, term: Optional[int]) -> Optional[Message]:
        """A fenced nack if `term` is stale, else None — the atomic
        decide-before-reply recheck merge handlers run after their
        (unlocked) sketch math, mirroring `_handle_prepare`'s gate."""
        if term is None:
            return None
        with self._meta:
            if term < self.term:
                return self._fenced_reply()
        return None

    def promote(self, name: str, version: Optional[int] = None) -> int:
        """Two-phase fleet-wide flip.  Phase 1 (`prepare`): every reachable
        host confirms it holds the target version (catching up if not);
        without a quorum of confirmations the promote aborts and NO live
        pointer has moved anywhere.  Phase 2 (`commit`): the promote op is
        appended, applied locally, and broadcast — each ack is a host that
        has atomically flipped.  Raises `ReplicationError` if the flip
        itself falls short of quorum (anti-entropy heals stragglers), or if
        a fenced (stale-term) reply reveals this leader was deposed —
        during phase 1 that abort moves NO live pointer anywhere."""
        if self.role != "leader":
            return self._forward("promote", name=name, version=version)
        with self._mutate:
            with self._meta:
                n = self.local.n_versions(name)     # raises on unknown name
                v = n - 1 if version is None else version
                if not 0 <= v < n:
                    raise IndexError(f"{name!r} has no version {v}")
                h = self._vhash.get(name, [None] * n)[v]
                term = self.term
            # phase 1: the fleet must HOLD v before anyone flips to it
            need = self._quorum_size()
            holders = 1                             # the leader holds it
            for p in self.transport.peers():
                try:
                    r = self.transport.send(
                        p, {"req": "prepare", "name": name, "version": v,
                            "hash": h, "term": term,
                            "from": self.transport.host_id})
                except TransportError:
                    continue
                if r.get("fenced"):
                    self._fenced(r, f"promote {name!r} v{v}",
                                 "aborted before any flip — the fleet is "
                                 "still uniformly on the old version")
                holders += 1 if r.get("ok") else 0
            if holders < need:
                raise ReplicationError(
                    f"promote {name!r} v{v}: only {holders}/{need} hosts hold "
                    f"the version — aborted before any flip (fleet still "
                    f"uniformly on the old version)")
            # phase 2: append + flip everywhere.  Re-check leadership under
            # the meta lock: a heartbeat with a higher term may have deposed
            # us while phase 1 was on the wire, and a deposed leader must
            # not move ANY live pointer.
            with self._meta:
                if self.role != "leader" or self.term != term:
                    raise ReplicationError(
                        f"promote {name!r} v{v}: deposed during prepare "
                        f"(term {term} -> {self.term}, leader "
                        f"{self.leader!r}) — aborted before any flip")
                op = Op(seq=self._applied.get(name, -1) + 1, kind="promote",
                        name=name, version=v, term=self.term)
                self.local.promote(name, v)
                self._commit_meta(op, None)
            flipped = 1 + self._broadcast(op, None)
            if flipped < need:
                raise ReplicationError(
                    f"promote {name!r} v{v}: flip acked by {flipped}/{need} "
                    f"hosts — the leader IS live on v{v}; stragglers converge "
                    f"via anti-entropy")
            return v

    def rollback(self, name: str) -> int:
        """Revert the fleet to the previous live version (replicated like
        any op; no quorum gate — rollback is the emergency path)."""
        if self.role != "leader":
            return self._forward("rollback", name=name)
        with self._mutate:
            with self._meta:
                v = self.local.rollback(name)
                op = Op(seq=self._applied.get(name, -1) + 1, kind="rollback",
                        name=name, version=v, term=self.term)
                self._commit_meta(op, None)
            self._broadcast(op, None)
            return v

    # ---- leader re-routing -------------------------------------------------
    _CLIENT_ERRORS = {"KeyError": KeyError, "IndexError": IndexError,
                      "ValueError": ValueError, "RuntimeError": RuntimeError,
                      "ReplicationError": ReplicationError}

    def _forward(self, kind: str, **kw: Any) -> int:
        """Re-route a mutation from this non-leader host to the current
        leader (how `DRService.promote` keeps working after a failover).
        Without an elector the static-fleet contract holds: followers are
        read replicas and mutating one raises."""
        if self.elector is None:
            self._require_leader(kind)
        with self._meta:
            ldr = self.leader
        if ldr is None or ldr == self.transport.host_id:
            raise ReplicationError(
                f"{kind} on {self.transport.host_id!r}: no known leader to "
                f"forward to (an election may be in progress — retry)")
        try:
            r = self.transport.send(ldr, {"req": "client", "kind": kind,
                                          **kw})
        except TransportError as e:
            raise ReplicationError(
                f"{kind}: forward to leader {ldr!r} failed ({e}) — "
                f"retry after the next election") from e
        if not r.get("ok"):
            exc = self._CLIENT_ERRORS.get(r.get("error_type"),
                                          ReplicationError)
            raise exc(r.get("error", f"{kind} failed on leader {ldr!r}"))
        return r["result"]

    def _handle_client(self, msg: Message) -> Message:
        """Leader side of `_forward`: run the mutation, ship the result (or
        the exception, by name) back to the forwarding host."""
        if self.role != "leader":
            with self._meta:
                return {"ok": False, "error_type": "ReplicationError",
                        "error": f"{self.transport.host_id!r} is not the "
                                 f"leader (try {self.leader!r}, "
                                 f"term {self.term})"}
        kind = msg["kind"]
        try:
            if kind == "register":
                result = self.register(msg["name"], msg["model"],
                                       msg["state"],
                                       ensemble=msg.get("ensemble"),
                                       replace=msg.get("replace", False))
            elif kind == "push":
                result = self.push(msg["name"], msg["state"])
            elif kind == "push_merged":
                result = self.push_merged(
                    msg["name"], msg["state"],
                    contributors=tuple(msg.get("contributors", ())))
            elif kind == "promote":
                result = self.promote(msg["name"], msg.get("version"))
            elif kind == "rollback":
                result = self.rollback(msg["name"])
            else:
                return {"ok": False, "error_type": "ReplicationError",
                        "error": f"unknown client mutation {kind!r}"}
            return {"ok": True, "result": result}
        except Exception as e:          # noqa: BLE001 — ship to the caller
            return {"ok": False, "error_type": type(e).__name__,
                    "error": str(e)}

    def _fenced(self, reply: Message, what: str, consequence: str) -> None:
        """A peer rejected our RPC as stale-term: adopt the higher term
        (stepping down) and abort the mutation."""
        self.observe_term(int(reply["term"]), reply.get("leader"))
        raise ReplicationError(
            f"{what}: fenced by term {reply['term']} (current leader "
            f"{reply.get('leader')!r}) — this host was deposed; "
            f"{consequence}")

    # ---- anti-entropy ------------------------------------------------------
    def sync(self) -> int:
        """Pull every op this host is missing from the leader (skipping
        state payloads already held, by content hash); returns the number
        of ops applied.  How a late joiner or healed partition converges."""
        if self.role == "leader":
            return 0
        with self._meta:
            leader = self.leader
        if leader is None:
            raise TransportError("no known leader to sync from")
        if hasattr(self.transport, "add_peer") and \
                leader not in self.transport.peers():
            raise TransportError(f"leader {leader!r} not in peer book")
        with self._meta:
            have = dict(self._applied)
            hashes = list(self._states)
            last_terms = self._last_terms()
        reply = self.transport.send(leader, {
            "req": "pull", "have": have, "hashes": hashes,
            "last_terms": last_terms})
        return self._ingest_bundle(reply)

    def join(self) -> int:
        """TCP fleets: announce this host's address to the leader (so
        broadcasts reach it), then `sync()`.  No-op on transports without
        an address book (the LocalBus knows everyone already)."""
        addr = getattr(self.transport, "address", None)
        if addr is not None:
            self.transport.send(self.leader, {
                "req": "join", "host_id": self.transport.host_id,
                "address": tuple(addr)})
        return self.sync()

    # ---- internals: apply / log -------------------------------------------
    # The seven `analysis: allow(blocking-under-lock)` waivers in this file
    # are the WAL / blob / compaction I/O the reference also does under
    # `_meta` (its analysis_baseline.json grandfathers the same seven): the
    # durable write must land before the op is visible to the fleet.
    def _commit_meta(self, op: Op, payload: Optional[PyTree]) -> None:
        # requires-lock: _meta
        """Record an op already applied to the local registry (caller holds
        `_meta`): log, applied seq, content store, version->hash map — and,
        on a durable host, blob + WAL (payload before op record, so a
        recovered WAL never references a blob the crash beat to disk)."""
        self._log.setdefault(op.name, []).append(op)
        self._applied[op.name] = op.seq
        if op.state_hash is not None and payload is not None:
            self._states.setdefault(op.state_hash, payload)
        if op.kind == "register":
            self._vhash[op.name] = [op.state_hash]
        elif op.kind in ("push", "merge"):
            self._vhash.setdefault(op.name, []).append(op.state_hash)
        if self.durable is not None and not self._recovering:
            if op.state_hash is not None and payload is not None:
                self.durable.blobs.put(op.state_hash, payload)  # analysis: allow(blocking-under-lock)
            self.durable.log_op(op)  # analysis: allow(blocking-under-lock)
            if self.durable.should_compact():
                self.durable.compact(self._durable_dump())  # analysis: allow(blocking-under-lock)

    def _last_terms(self) -> Dict[str, int]:
        """Per-name term of the LAST op held (caller holds `_meta`) — the
        divergence fingerprint every pull/nack sends so the leader can
        spot a deposed leader's uncommitted suffix."""
        return {n: log[-1].term for n, log in self._log.items() if log}

    def _reset_name(self, name: str) -> None:
        """Drop this host's per-name log so a full replay from the leader
        rebuilds it — how a deposed leader's uncommitted (diverged) suffix
        is rewound.  The content-addressed state store survives: hashes the
        replay needs again are never re-shipped."""
        with self._meta:
            self._log.pop(name, None)
            self._applied.pop(name, None)
            self._vhash.pop(name, None)
            if self.durable is not None and not self._recovering:
                self.durable.log_reset(name)  # analysis: allow(blocking-under-lock)

    def _ingest_bundle(self, bundle: Message) -> int:
        """Apply a pull/catchup bundle.  Ordinary names replay their
        missing ops straight into the live registry.  A RESET name (log
        divergence) is replayed into a scratch registry and adopted in
        one atomic step, so live readers never see the partially-rebuilt
        entry (a mid-replay read would otherwise serve version 0).  A
        reset name with NO ops at all is a phantom — a name a deposed
        leader registered while partitioned from everyone — and its local
        entry is dropped outright: no other host has it, and keeping it
        would both serve a model the fleet never committed and poison the
        vote-freshness check against every legitimate candidate."""
        payloads = bundle.get("payloads", {})
        ops = bundle.get("ops", {})
        resets = set(bundle.get("reset", ()))
        sender_term = bundle.get("term")
        # Fence the WHOLE bundle up front, not just per-op: `_apply`
        # checks the sender term on every op, but a reset with no ops
        # (the phantom-drop path below) never reaches `_apply` — without
        # this gate a deposed leader's stale pull reply could drop a
        # name the NEW leader has since committed.
        if sender_term is not None:
            with self._meta:
                if sender_term < self.term:
                    raise _Fenced(
                        f"stale bundle from term {sender_term} rejected: "
                        f"this host has seen term {self.term}")
        applied = 0
        for name, missing in ops.items():
            if name in resets:
                self._reset_name(name)
                shadow = ModelRegistry()
                for op in missing:
                    applied += 1 if self._apply(op, payloads, shadow,
                                                sender_term) else 0
                self.local.adopt(name, shadow)
            else:
                for op in missing:
                    applied += 1 if self._apply(op, payloads,
                                                sender_term=sender_term) \
                        else 0
        for name in resets - set(ops):
            self._reset_name(name)
            self.local.remove(name)
        return applied

    def _apply(self, op: Op, payloads: Dict[str, PyTree],
               registry: Optional[ModelRegistry] = None,
               sender_term: Optional[int] = None) -> bool:
        """Idempotently apply a replicated op to the local registry (or to
        `registry`, a reset-replay's scratch target — op-log bookkeeping
        always lands on self).  Returns True if it mutated (False: already
        applied).  Raises `ReplicationError` on a sequence gap, missing
        payload, or a log divergence (same seq, different term — this host
        holds a deposed leader's uncommitted op) — the caller decides
        whether to sync and retry.

        `sender_term` is the term of the MESSAGE that delivered the op
        (not `op.term`, which is the op's creation term and legitimately
        old during catch-up replay).  Checking it inside the `_meta` hold
        makes term-check-and-apply atomic: without it, a host could pass
        the handler's fencing gate, grant a vote to a higher-term
        candidate on another thread, and then still ack the deposed
        leader's op — exactly the window that loses a committed promote."""
        target = registry if registry is not None else self.local
        with self._meta:
            if sender_term is not None and sender_term < self.term:
                raise _Fenced(
                    f"{op.kind} {op.name!r}: message term {sender_term} went "
                    f"stale (current term {self.term})")
            applied = self._applied.get(op.name, -1)
            if op.seq <= applied:
                log = self._log.get(op.name, [])
                mine = log[op.seq] if op.seq < len(log) else None
                if mine is not None and mine.term != op.term:
                    # an idempotent skip here would silently keep the stale
                    # op and ack — the leader must reset-replay us instead
                    raise ReplicationError(
                        f"log divergence for {op.name!r} at seq {op.seq}: "
                        f"held term {mine.term} != incoming term {op.term} "
                        f"— sync required")
                return False                        # replay — idempotent skip
            if op.seq > applied + 1:
                raise ReplicationError(
                    f"op gap for {op.name!r}: have seq {applied}, got "
                    f"{op.seq} — sync required")
            payload = None
            if op.state_hash is not None:
                payload = self._states.get(op.state_hash,
                                           payloads.get(op.state_hash))
                if payload is None:
                    raise ReplicationError(
                        f"missing payload {op.state_hash} for "
                        f"{op.kind} {op.name!r} — sync required")
            if op.kind == "register":
                target.register(op.name, op.model,
                                _installed(op.model, payload),
                                ensemble=op.ensemble, replace=True)
            elif op.kind in ("push", "merge"):
                got = target.push(
                    op.name, _installed(target.get(op.name).model, payload))
                if got != op.version:
                    raise ReplicationError(
                        f"{op.kind} {op.name!r}: local version {got} != "
                        f"op version {op.version} — log divergence")
            elif op.kind == "promote":
                target.promote(op.name, op.version)
            elif op.kind == "rollback":
                target.rollback(op.name)
            else:
                raise ReplicationError(f"unknown op kind {op.kind!r}")
            self._commit_meta(op, payload)
            return True

    def _broadcast(self, op: Op, payloads: Optional[Dict[str, PyTree]]) -> int:
        """Send one op to every peer; returns the ack count.  A peer that
        reports a gap gets one inline catch-up (sync bundle) retry; an
        unreachable peer is simply not acked (anti-entropy later).  A
        FENCED reply (the peer has seen a higher term) deposes this leader:
        it steps down and the mutation aborts with `ReplicationError`."""
        acks = 0
        msg = {"req": "op", "op": op, "payloads": payloads or {},
               "term": op.term, "from": self.transport.host_id}
        for p in self.transport.peers():
            try:
                r = self.transport.send(p, msg)
                if r.get("fenced"):
                    self._fenced(r, f"{op.kind} {op.name!r}",
                                 "peers that already acked converge on the "
                                 "new leader via anti-entropy")
                if not r.get("ok") and r.get("need_sync"):
                    self._heal_peer(p, r.get("have", {}), r.get("hashes", []),
                                    r.get("last_terms"))
                    r = self.transport.send(p, msg)
                acks += 1 if r.get("ok") else 0
            except TransportError:
                pass
        return acks

    def _heal_peer(self, peer: str, have: Dict[str, int], hashes: List[str],
                   last_terms: Optional[Dict[str, int]] = None) -> None:
        """Push a catch-up bundle (ops past `have`, payloads not in
        `hashes`, full reset-replays for diverged names) to a peer that
        nacked with a gap or divergence."""
        bundle = self._pull_bundle(have, hashes, last_terms)  # stamps term
        self.transport.send(peer, {"req": "catchup", **bundle,
                                   "from": self.transport.host_id})

    def _pull_bundle(self, have: Dict[str, int], hashes: List[str],
                     last_terms: Optional[Dict[str, int]] = None,
                     ) -> Dict[str, Any]:
        held = set(hashes)
        with self._meta:
            ops: Dict[str, List[Op]] = {}
            payloads: Dict[str, PyTree] = {}
            reset: List[str] = []
            for name, log in self._log.items():
                fseq = have.get(name, -1)
                if fseq >= 0 and last_terms is not None and (
                        fseq >= len(log)
                        or log[fseq].term != last_terms.get(name)):
                    # the puller's log diverged from ours (a deposed
                    # leader's uncommitted suffix): ship the WHOLE log and
                    # tell it to rebuild the name from scratch
                    missing = list(log)
                    reset.append(name)
                else:
                    missing = [op for op in log if op.seq > fseq]
                if not missing:
                    continue
                ops[name] = missing
                for op in missing:
                    if op.state_hash is not None and op.state_hash not in held:
                        payloads[op.state_hash] = self._states[op.state_hash]
            if last_terms is not None:
                # phantom names: the puller has a log for a name WE have no
                # log for at all — a deposed leader's register that reached
                # nobody.  Reset with no ops == drop the entry outright.
                reset.extend(n for n, s in have.items()
                             if s >= 0 and n not in self._log)
            # stamp the sender's term so the puller's atomic apply-time
            # fence is LIVE for pull replies too: without it a follower
            # that already adopted a higher term would ingest a deposed
            # leader's uncommitted suffix unfenced
            return {"ops": ops, "payloads": payloads, "reset": reset,
                    "term": self.term}

    # ---- incoming messages -------------------------------------------------
    def _handle(self, msg: Message) -> Message:
        req = msg.get("req")
        if req in ("vote", "heartbeat"):
            if self.elector is None:
                return {"ok": False, "granted": False,
                        "error": "no elector attached"}
            return self.elector.handle(msg)
        fenced = self._check_term(msg)
        if fenced is not None:
            return fenced
        if req == "op":
            return self._handle_op(msg)
        if req == "prepare":
            return self._handle_prepare(msg)
        if req == "client":
            return self._handle_client(msg)
        if req == "pull":
            return self._pull_bundle(msg.get("have", {}),
                                     msg.get("hashes", []),
                                     msg.get("last_terms"))
        if req == "catchup":
            try:
                self._ingest_bundle(msg)
            except _Fenced:
                return self._fenced_reply()
            return {"ok": True}
        if req in ("merge_collect", "merge_commit"):
            if self.merger is None:
                return {"ok": False, "error": "no merger attached"}
            return self.merger.handle(msg)
        if req == "status":
            return self.status()
        if req == "join":
            add_peer = getattr(self.transport, "add_peer", None)
            if add_peer is not None:
                add_peer(msg["host_id"], tuple(msg["address"]))
            return {"ok": True}
        return {"ok": False, "error": f"unknown request {req!r}"}

    def _check_term(self, msg: Message) -> Optional[Message]:
        """Fencing gate for leader-originated RPCs (`op`, `prepare`,
        `catchup`, `merge_collect`, `merge_commit`): a message from a
        stale term is rejected with a fenced nack naming the current term
        and leader; a HIGHER term is adopted on the spot (the sender is
        the leader asserting it).  Messages without a term (static
        fleets, reads) pass untouched."""
        term = msg.get("term")
        if term is None or msg.get("req") not in (
                "op", "prepare", "catchup", "merge_collect", "merge_commit"):
            return None
        with self._meta:
            if term < self.term:
                return self._fenced_reply()
        src = msg.get("from")
        self.observe_term(term, leader=src)
        if self.elector is not None and src is not None:
            # a current-term op from the leader is as good as a heartbeat
            self.elector.observe_leader(term, src)
        return None

    def _handle_op(self, msg: Message) -> Message:
        sender_term = msg.get("term")
        try:
            self._apply(msg["op"], msg.get("payloads", {}),
                        sender_term=sender_term)
            return {"ok": True}
        except _Fenced:
            return self._fenced_reply()
        except ReplicationError:
            # gap or missing payload: try a self-serve sync from the leader
            # (reachable on a LocalBus; on TCP the leader's retry heals us)
            try:
                self.sync()
                self._apply(msg["op"], msg.get("payloads", {}),
                            sender_term=sender_term)
                return {"ok": True}
            except _Fenced:
                return self._fenced_reply()
            except (TransportError, ReplicationError):
                with self._meta:
                    return {"ok": False, "need_sync": True,
                            "have": dict(self._applied),
                            "hashes": list(self._states),
                            "last_terms": self._last_terms()}

    def _fenced_reply(self) -> Message:
        with self._meta:
            return {"ok": False, "fenced": True, "term": self.term,
                    "leader": self.leader}

    def _handle_prepare(self, msg: Message) -> Message:
        name, v, h = msg["name"], msg["version"], msg.get("hash")
        if not self._holds(name, v, h):
            try:
                self.sync()                         # catch up, then re-check
            except (TransportError, ReplicationError):
                pass
        # decide + term-recheck under ONE meta hold: a vote granted to a
        # higher-term candidate on another thread between the handler's
        # fencing gate and this reply must flip the answer to fenced — an
        # ok here is a promise to the OLD leader's quorum
        with self._meta:
            t = msg.get("term")
            if t is not None and t < self.term:
                return self._fenced_reply()
            return {"ok": self._holds(name, v, h)}

    def holds_content(self, name: str, version: int, h: str) -> bool:
        """Does the fleet's CURRENT leader hold `version` of `name` with
        content `h`?  `DRService.promote` asks this before re-promoting a
        version it pushed earlier: after a failover the new leader may
        never have received that push (or hold different content under the
        same version id), in which case the staged state must be pushed
        afresh instead of flipping the fleet to the wrong bytes."""
        if self.role == "leader":
            return self._holds(name, version, h)
        with self._meta:
            ldr = self.leader
        if ldr is None or ldr == self.transport.host_id:
            return False
        try:
            r = self.transport.send(ldr, {"req": "prepare", "name": name,
                                          "version": version, "hash": h})
        except TransportError:
            return False
        return bool(r.get("ok"))

    def _holds(self, name: str, version: int, h: Optional[str]) -> bool:
        """True iff this host holds `version` of `name` with the expected
        CONTENT.  Version count alone is not enough: after a
        register(replace=True) a stale host's old generation can have the
        same version ids with different states — the hash is the truth."""
        try:
            if not 0 <= version < self.local.n_versions(name):
                return False
        except KeyError:
            return False
        with self._meta:
            vh = self._vhash.get(name, [])
        local_h = vh[version] if version < len(vh) else None
        return h is None or local_h == h

    def _quorum_size(self) -> int:
        n = 1 + len(self.transport.peers())
        return self.quorum if self.quorum is not None else n // 2 + 1

    def _require_leader(self, what: str) -> None:
        if self.role != "leader":
            raise ReplicationError(
                f"{what} on follower {self.transport.host_id!r}: followers "
                f"are read replicas — mutate via the leader ({self.leader!r})")

    def close(self) -> None:
        self.transport.close()
        if self.durable is not None:
            self.durable.close()
