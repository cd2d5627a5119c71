"""Leader election + fencing for the replicated registry.

A fleet with one *static* leader can never promote again once that host
dies.  This module makes the leader a role the fleet re-assigns: each host runs an `Elector` over the same `Transport` its
`ReplicatedRegistry` replicates on, with all time read through the
injectable `Clock` (randomized election timeouts on a `VirtualClock` in
tests — zero `time.sleep` — and `MonotonicClock` in production).

The protocol is term-numbered, Raft-shaped, specialized to the op-log
registry:

  * **Heartbeats** — the leader broadcasts `heartbeat {term}` every
    `heartbeat_interval_ms`.  A follower that hears nothing for its
    (randomized) election timeout becomes a candidate.
  * **Votes** — a candidate bumps the term, votes for itself, and asks
    every peer for a vote, attaching its log fingerprint
    (`ReplicatedRegistry.log_summary()`: per-name (last op term, seq)).
    A voter grants at most one vote per term, and ONLY to a candidate
    whose log is at least as fresh as its own on every name — comparing
    (term, seq) lexicographically — so an elected leader always holds
    every quorum-committed op and never rewinds registry history.
  * **Fencing** — every replication RPC carries the sender's term.
    A host that has seen a higher term rejects stale-term messages with
    a fenced nack; the deposed leader steps down on the spot and its
    in-flight two-phase promote aborts cleanly (phase 1 aborts move no
    live pointer anywhere; an uncommitted phase-2 suffix is rewound by
    anti-entropy's divergence reset when the host rejoins).
  * **Re-routing** — once an elector is attached, mutations issued on a
    non-leader host forward to the current leader, so a
    `DRService.promote` retried after a failover just works.

Determinism: `poll()` does ALL the work (timeout checks, vote rounds,
heartbeats) synchronously in the caller's thread — a test advances the
`VirtualClock` and pumps `poll()`; nothing happens in between.  `start()`
runs the same `poll()` from a background loop parked on `Clock.wait` for
production fleets.
"""

from __future__ import annotations

import random
import threading
from typing import Any, Dict, Optional, Tuple

from repro_torch.serve.clock import Clock, MonotonicClock
from repro_torch.serve.replication import ReplicatedRegistry
from repro_torch.serve.transport import Message, TransportError


class Elector:
    """One host's election state machine (leader | follower | candidate).

    `registry` is the host's `ReplicatedRegistry` — the elector attaches
    itself (vote/heartbeat messages dispatch here; mutations forward to
    the leader) and drives role flips through `registry.become_leader` /
    `registry.observe_term`, so the registry's `term` is the single
    fencing epoch both layers share.

    `election_timeout_ms` is a (lo, hi) range; each election waits a
    fresh uniform draw from it (seeded `random.Random(seed)`, so tests
    are reproducible and distinct seeds give distinct timeouts — the
    classic split-vote breaker).  `heartbeat_interval_ms` must be well
    under `lo`.
    """

    def __init__(self, registry: ReplicatedRegistry, *,
                 clock: Optional[Clock] = None, seed: int = 0,
                 election_timeout_ms: Tuple[float, float] = (150.0, 300.0),
                 heartbeat_interval_ms: float = 50.0):
        lo, hi = election_timeout_ms
        if not 0 < lo <= hi:
            raise ValueError(f"bad election timeout range ({lo}, {hi})")
        if heartbeat_interval_ms >= lo:
            raise ValueError(
                f"heartbeat interval {heartbeat_interval_ms} must be below "
                f"the election timeout floor {lo} — a healthy leader would "
                f"be deposed between its own beats")
        self.reg = registry
        self.transport = registry.transport
        self.host_id = registry.transport.host_id
        self.clock: Clock = clock if clock is not None else MonotonicClock()
        self.rng = random.Random(seed)
        self.election_timeout_ms = (float(lo), float(hi))
        self.heartbeat_interval_ms = float(heartbeat_interval_ms)
        # election RPCs are useless after the timescale they serve: cap
        # each beat/vote send at one heartbeat interval so a single hung
        # TCP peer (default transport timeout: seconds) can't stall a
        # beat round past the other followers' election timers and depose
        # a healthy leader
        self.rpc_timeout_s = self.heartbeat_interval_ms / 1e3
        # `_lock` guards elector-local state only and is NEVER held across
        # transport I/O (vote rounds / heartbeats run on a snapshot), so
        # two threaded electors messaging each other cannot deadlock.
        self._lock = threading.RLock()
        self.state = "leader" if registry.role == "leader" else "follower"  # guarded-by: _lock
        # term -> candidate granted.  Seeded from the registry's persisted
        # vote map (durable hosts): a vote granted before a crash is a
        # vote granted after the restart — never a second grant per term.
        self._voted: Dict[int, str] = dict(registry.recovered_votes())  # guarded-by: _lock
        self._last_heartbeat = self.clock.now()  # guarded-by: _lock
        self._last_beat_sent = float("-inf")  # guarded-by: _lock
        self._timeout_ms = self._new_timeout()  # guarded-by: _lock
        self.elections_started = 0  # guarded-by: _lock
        self.won_terms: list = []  # guarded-by: _lock (terms this host won (tests))
        self._closed = False  # guarded-by: _cond
        self._thread: Optional[threading.Thread] = None
        self._cond = threading.Condition()
        registry.attach_elector(self)

    # ---- introspection -----------------------------------------------------
    @property
    def term(self) -> int:
        return self.reg.term

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {"host": self.host_id, "state": self.state,
                    "term": self.reg.term, "leader": self.reg.leader,
                    "timeout_ms": self._timeout_ms,
                    "elections_started": self.elections_started,
                    "won_terms": list(self.won_terms)}

    def deadline_ms(self) -> float:
        """When this elector next needs a `poll()`: the leader's next
        heartbeat, or the follower/candidate's election-timeout expiry.
        Deterministic pumps advance the clock exactly here."""
        with self._lock:
            if self.state == "leader" and self.reg.role == "leader":
                return self._last_beat_sent + self.heartbeat_interval_ms
            return self._last_heartbeat + self._timeout_ms

    # ---- the single step ---------------------------------------------------
    def poll(self) -> None:
        """One synchronous protocol step: reconcile an externally-observed
        step-down, then send heartbeats (leader) or check the election
        timeout and run a vote round (follower/candidate).  Safe to call
        as often as you like; does nothing until a deadline passes."""
        now = self.clock.now()
        with self._lock:
            if self.state == "leader" and self.reg.role != "leader":
                # fenced while replicating: the registry already stepped
                # down — fall back to follower with a fresh grace period
                self._step_down(now)
            state = self.state
        if state == "leader":
            if now - self._last_beat_sent >= self.heartbeat_interval_ms:
                self._send_heartbeats(now)
        elif now - self._last_heartbeat >= self._timeout_ms:
            self._run_election(now)

    def _step_down(self, now: float) -> None:
        # requires-lock: _lock
        """Demote to follower with a fresh grace period (caller holds
        `_lock`) — the one shape every demotion site shares."""
        self.state = "follower"
        self._last_heartbeat = now
        self._timeout_ms = self._new_timeout()

    # ---- leader side -------------------------------------------------------
    def _send_heartbeats(self, now: float) -> None:
        with self._lock:
            self._last_beat_sent = now
        msg = {"req": "heartbeat", "term": self.reg.term,
               "from": self.host_id}
        for p in self.transport.peers():
            try:
                r = self.transport.send(p, msg,
                                        timeout_s=self.rpc_timeout_s)
            except TransportError:
                continue
            if r.get("fenced") and r.get("term", 0) > self.reg.term:
                # a higher term is out there: we were deposed while
                # partitioned — step down instead of split-brain serving
                self.reg.observe_term(int(r["term"]), r.get("leader"))
                with self._lock:
                    self._step_down(self.clock.now())
                return

    # ---- candidate side ----------------------------------------------------
    def _run_election(self, now: float) -> None:
        """Bump the term, vote for self, collect votes; win on a majority
        of the whole fleet (self + all peers, reachable or not)."""
        new_term = self.reg.start_candidacy()
        with self._lock:
            prior = self._voted.get(new_term)
            if prior is not None and prior != self.host_id:
                # between the term bump and this lock, a handler thread
                # granted OUR vote at new_term to another candidate — a
                # self-vote now would be a double vote, and two symmetric
                # candidates double-voting is how two leaders win the SAME
                # term (same-term split-brain defeats divergence
                # detection).  The vote stands; this candidacy folds.
                self._step_down(now)
                return
            self.state = "candidate"
            self._voted[new_term] = self.host_id
            self._last_heartbeat = now          # restart the election timer
            self._timeout_ms = self._new_timeout()
            self.elections_started += 1
        # persist the self-vote BEFORE asking anyone else for theirs: a
        # candidate that crashes mid-round must not wake up and grant its
        # own term's vote to a rival (the self-vote already counted)
        self.reg.persist_vote(new_term, self.host_id)
        summary = self.reg.log_summary()
        peers = self.transport.peers()
        need = (1 + len(peers)) // 2 + 1
        votes = 1                               # self-vote
        for p in peers:
            try:
                r = self.transport.send(p, {"req": "vote", "term": new_term,
                                            "from": self.host_id,
                                            "log": summary},
                                        timeout_s=self.rpc_timeout_s)
            except TransportError:
                continue
            if r.get("term", 0) > new_term:
                # someone is already past this term — adopt and stand down
                self.reg.observe_term(int(r["term"]))
                with self._lock:
                    self._step_down(self.clock.now())
                return
            if r.get("granted"):
                votes += 1
        if votes < need:
            return                              # split/failed: retry later
        if not self.reg.become_leader(new_term):
            with self._lock:                    # a higher term won the race
                self._step_down(self.clock.now())
            return
        with self._lock:
            self.state = "leader"
            self.won_terms.append(new_term)
        # assert leadership immediately: fences the old leader, stops the
        # other followers' election timers, and teaches everyone the route
        # for forwarded mutations
        self._send_heartbeats(self.clock.now())

    # ---- voter / follower side ---------------------------------------------
    def handle(self, msg: Message) -> Message:
        """Incoming `vote` / `heartbeat` (dispatched by the registry)."""
        if msg.get("req") == "vote":
            return self._on_vote(msg)
        return self._on_heartbeat(msg)

    def _on_vote(self, msg: Message) -> Message:
        term, cand, log = int(msg["term"]), msg["from"], msg.get("log", {})
        if term < self.reg.term:
            return {"granted": False, "term": self.reg.term,
                    "leader": self.reg.leader}
        if term > self.reg.term:
            self.reg.observe_term(term)         # steps down if leader
            with self._lock:
                if self.state != "follower":
                    self.state = "follower"
        fresh = self._fresh_enough(log)
        with self._lock:
            voted = self._voted.get(term)
            grant = fresh and voted in (None, cand)
            if grant:
                self._voted[term] = cand
                # granting resets the timer: give the winner time to beat
                self._last_heartbeat = self.clock.now()
        if grant:
            # fsync the grant BEFORE the reply leaves this host: once the
            # candidate counts this vote, no restart may re-grant the term
            self.reg.persist_vote(term, cand)
        return {"granted": grant, "term": self.reg.term}

    def _on_heartbeat(self, msg: Message) -> Message:
        term, leader = int(msg["term"]), msg["from"]
        status = self.reg.leader_status()
        if term < status["term"]:
            return {"ok": False, "fenced": True, "term": status["term"],
                    "leader": status["leader"]}
        self.reg.observe_term(term, leader=leader)
        with self._lock:
            self.state = "follower"
            self._last_heartbeat = self.clock.now()
        return {"ok": True, "term": self.reg.term}

    def observe_leader(self, term: int, leader: str) -> None:
        """A current-term replication op arrived from the leader — counts
        as a heartbeat (the registry already adopted term/leader)."""
        if term < self.reg.term:
            return
        with self._lock:
            if self.state != "leader":
                self.state = "follower"
                self._last_heartbeat = self.clock.now()

    def _fresh_enough(self, cand_log: Dict[str, Tuple[int, int]]) -> bool:
        """Grant only to candidates whose op log (term, seq) is >= ours on
        every name we hold — the rule that keeps committed history safe:
        a quorum-committed op lives on a majority, every election needs a
        majority, and the two must intersect in a voter that enforces
        this check."""
        for name, mine in self.reg.log_summary().items():
            theirs = cand_log.get(name)
            if theirs is None or tuple(theirs) < tuple(mine):
                return False
        return True

    def _new_timeout(self) -> float:
        lo, hi = self.election_timeout_ms
        return self.rng.uniform(lo, hi)

    # ---- background loop (production) --------------------------------------
    def start(self) -> "Elector":
        """Run `poll()` from a daemon loop parked on `Clock.wait` until the
        next deadline — the production mode (`MonotonicClock`).  Tests
        pump `poll()` directly instead."""
        if self._thread is not None:
            raise RuntimeError("elector loop already started")
        register = getattr(self.clock, "register", None)
        if register is not None:                # VirtualClock: advance() wakes
            register(self._cond)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"elector-{self.host_id}")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while True:
            with self._cond:
                if self._closed:
                    return
            self.poll()
            with self._cond:
                if self._closed:
                    return
                delay = max(1.0, self.deadline_ms() - self.clock.now())
                self.clock.wait(self._cond, delay)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
