"""Fleet-wide sharded train-while-serve: compressed staged-delta merge.

Every host's `serve_and_update` keeps folding its local traffic shard
into a staged state, exactly as before.  This module adds the periodic
exchange: a leader-coordinated **merge round** that makes the next
promoted state reflect the whole fleet's traffic instead of one host's —
the data-parallel recipe shape applied to online DR fitting, with the
paper's own ternary-RP sketch as the compressor.

One round, driven by `FleetMerger.merge_round(name)` on the current
leader:

    leader                                 every host (leader included)
    ──────                                 ───────────────────────────
    base = live state, hash, term, salt
    ── merge_collect(name, base_hash,      fence term; sync onto base
                     term, salt) ──▶       resolve previous pending carry
                                             against the merge-op log
                                           CONSUME staged chain under the
                                             per-name train-while-serve
                                             lock (engine.extract_staged)
                                           v = (staged − chain_base) + carry
                                           sketch = ternary-RP(v) @ salt
                                           WAL pending carry {v, v − Pv}
                                             + fsync  ◀ BEFORE ack
                        ◀── sketch bundle ──
    Σ sketches → one projection decode
    merged = base + Σ decoded deltas
    push_merged (op kind "merge", names contributors)
    two-phase quorum promote  (term-fenced: a deposed leader aborts here
                               with NO live pointer moved anywhere)
    ── merge_commit(salt) ──▶              finalize carry: v → v − Pv
                                           (what this round installed is
                                            dropped; what the sketch
                                            missed is carried forward)

Correctness anchors:

  * **Deltas, not states.**  Each host ships `staged − chain_base` — its
    OWN folds only, measured against the base its chain actually started
    from.  Disjoint shards therefore SUM on the leader, and N hosts
    streaming disjoint shards + merge + promote ≡ offline `fit` on the
    union (first-order in the learning rate; the compression tolerance on
    top of that is pinned by tests).  Integer leaves (the int8 ternary RP
    stage, the int32 step counter) ride the raw path bit-exactly, so the
    merged step count is exactly the fleet's total block count.
  * **Extraction consumes; the carry record is the single owner.**  A
    collect pops the staged chain and folds it into the host's carry
    `v = delta + previous residual`.  The carry is WAL'd + fsync'd as
    PENDING (both `v` and the post-sketch residual `v − Pv`) BEFORE the
    sketch is acked.  Commit finalizes it to `v − Pv`; an aborted round
    leaves the full `v` — nothing double-counted, nothing lost, whichever
    way the round ends.  A host that crashes between the WAL and the ack
    restarts with its pending record and resolves it against the durable
    merge-op log (`merge_landed`: did a promoted merge newer than the
    extraction seq name me?) — exactly-once residual accounting without
    trusting commit-message delivery.
  * **Error feedback contracts because the decode is a projection.**  The
    leader (and each host, for its residual) decodes sketches with the
    least-squares projection onto rowspace(R), salted per round — see
    `repro_torch.dist.compress`: ‖v − Pv‖ ≤ ‖v‖ deterministically and a fresh
    random subspace each round gives E‖e'‖² = (1 − 1/ratio)·E‖e‖², so K
    rounds converge geometrically to the uncompressed merge.  (An
    unbiased back-projection, as the mesh path's gradient sync uses,
    DIVERGES under this iteration — its variance is ≈ ratio·‖v‖².)
  * **Term-fenced like every fleet mutation.**  Collect requests carry
    the leader's term (`_check_term` gates them); a fenced reply deposes
    the merge leader and aborts the round before ANY install.  The
    install itself is the existing two-phase quorum promote, which
    re-checks leadership under `_meta`.

On the card.  Every host's staged chain and live state lie on its model's
device, so the delta, the carry and the sketch are computed there: the
sketch y = chunks Rᵀ runs on `ternary_matmul` (B3) under the kernel
backend (`compress.delta_sketch(..., backend=...)` follows the model's
`Execution`), and the merged state is built on the leader's device.  What
crosses the transport (the sketch bundles) and what the WAL holds (the
carry records) are host copies.  A carry recovered from the WAL is put
back on the live state's devices before it is used.

Locking: `_round` is a deliberate coarse lock (one merge round at a
time, held across collect + merge + install, like replication's
`_mutate`).  The sketch/merge math and every transport send happen
either under that coarse lock or under no lock at all — never inside
`_meta`/`_tws_guard` critical sections (the `blocking-under-lock`
discipline).  Carry records are guarded by their own leaf lock.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from repro_torch import tree as tree_mod
from repro_torch.dist import compress
from repro_torch.serve.replication import ReplicationError
from repro_torch.serve.transport import Message, TransportError

PyTree = Any


class MergeError(ReplicationError):
    """A merge round could not run or was fenced/aborted cleanly."""


def _backend(model: Any) -> str:
    """Where a host's sketch runs: B3 under the kernel backend, the plain
    product under the torch backend."""
    exe = getattr(model, "execution", None)
    return "kernel" if exe is None or exe.use_kernel else "torch"


def _tree_delta(staged: PyTree, base: PyTree) -> PyTree:
    """`staged − base`, leaf-wise, preserving leaf dtypes (int leaves
    subtract exactly; the int32 step counter's delta is its block count)."""
    return tree_mod.tree_map(lambda s, b: s - b, staged, base)


def _tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_mod.tree_map(lambda x, y: x + y, a, b)


def _ef_matches(ef: PyTree, like: PyTree) -> bool:
    """Does a (possibly recovered) carry tree still mirror the model
    state?  A register(replace=True) can change shapes between rounds —
    a stale carry is dropped, not crashed on."""
    try:
        fe = tree_mod.leaves(ef)
        fl = tree_mod.leaves(like)
    except Exception:                       # noqa: BLE001 — malformed tree
        return False
    return (len(fe) == len(fl)
            and all(tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype
                    for a, b in zip(fe, fl)))


def _placed(carry: PyTree, like: PyTree) -> PyTree:
    """`carry` with each leaf on the device of `like`'s matching leaf (a
    carry recovered from the WAL is a host copy)."""
    return tree_mod.tree_map(lambda c, l: c.to(l.device), carry, like)


def _settled(carry: Optional[PyTree]) -> Dict[str, Any]:
    """A carry record with a known outcome (nothing awaiting a round)."""
    return {"carry": carry, "final": None, "salt": 0, "seq": -1,
            "pending": False}


class FleetMerger:
    """Per-host merge agent over one `DRService` + `ReplicatedRegistry`.

    Attach one per host (the constructor wires itself into the registry's
    message routing via `attach_merger`).  Any host can *handle* collect
    and commit messages; only the current leader may *drive* a round.

        merger = FleetMerger(svc, compress_cfg=CompressConfig(ratio=8))
        report = merger.merge_round("m")      # on the leader

    `compress_cfg.ratio == 1` is the exact path: every leaf rides the raw
    branch, carries flush completely every committed round, and the
    merged state equals the uncompressed delta sum bit-for-bit (modulo
    float re-association) — the baseline the compressed rounds are
    toleranced against.

    The per-host carry record (`_residuals[name]`) is the error-feedback
    state machine:

        {"carry": v, "final": v − Pv, "salt": s, "seq": q, "pending": True}

    while a round's outcome is unknown, then `_settled(carry)` once it
    resolves — `final` on commit (the sketch was installed), the full
    `carry` on abort.  Records are persisted through the registry WAL
    (`persist_residual`) before every ack, so the state machine survives
    crashes and resumes from the log.
    """

    def __init__(self, service: Any, registry: Optional[Any] = None, *,
                 compress_cfg: Optional[compress.CompressConfig] = None):
        self.service = service
        reg = registry if registry is not None else service.registry
        if not hasattr(reg, "attach_merger"):
            raise TypeError(
                "FleetMerger needs a ReplicatedRegistry (attach_merger); "
                f"got {type(reg).__name__}")
        self.reg = reg
        self.cfg = compress_cfg if compress_cfg is not None \
            else compress.CompressConfig(ratio=8, min_size=64)
        # one merge round at a time, held across collect + merge + install
        self._round = threading.RLock()  # coarse-lock: collect+merge+install serialize by design, incl. transport sends
        self._res_lock = threading.Lock()
        self._residuals: Dict[str, Dict[str, Any]] = {}  # guarded-by: _res_lock
        self.rounds = 0                          # guarded-by: _round
        self.installs = 0                        # guarded-by: _round
        recovered = getattr(reg, "recovered_residuals", None)
        if recovered is not None:
            with self._res_lock:
                self._residuals.update(recovered())
        reg.attach_merger(self)

    # ---- introspection -----------------------------------------------------
    @property
    def host_id(self) -> str:
        return self.reg.transport.host_id

    def residual(self, name: str) -> Optional[PyTree]:
        """The carry tree for `name` (the host's un-installed signal), or
        None.  While a round is in flight this is the pre-sketch `v`."""
        with self._res_lock:
            rec = self._residuals.get(name)
        return None if rec is None else rec["carry"]

    def residual_record(self, name: str) -> Optional[Dict[str, Any]]:
        with self._res_lock:
            rec = self._residuals.get(name)
        return None if rec is None else dict(rec)

    def stats(self) -> Dict[str, Any]:
        with self._res_lock:
            names = sorted(self._residuals)
        return {"host": self.host_id, "rounds": self.rounds,
                "installs": self.installs, "residual_names": names}

    # ---- leader side: one merge round --------------------------------------
    def merge_round(self, name: str) -> Dict[str, Any]:
        """Run one leader-coordinated merge round for `name`.  Returns a
        round report (contributors, wire bytes, installed version — or
        `version=None` when nothing was staged anywhere).  Raises
        `MergeError` if this host does not lead or a fenced reply deposes
        it mid-collect; `ReplicationError` if the install's quorum
        promote aborts (no live pointer has moved in either case — every
        host's signal survives in its pending carry)."""
        with self._round:
            status = self.reg.leader_status()
            if status["role"] != "leader":
                raise MergeError(
                    f"merge_round({name!r}) on {self.host_id!r}: not the "
                    f"leader (term {status['term']}, leader "
                    f"{status['leader']!r}) — drive rounds from the leader")
            term = status["term"]
            t0 = self.service.clock.now()
            snap = self.reg.get(name)           # raises on unknown name
            base = snap.state
            base_hash = self.reg.version_hash(name, snap.version)
            self.rounds += 1
            # the round's R draw: any value works as long as every
            # contributor uses it (it rides the collect message) and
            # successive rounds differ, so carried residuals project onto
            # fresh subspaces (the contraction in repro_torch.dist.compress)
            salt = (int(snap.version) * 1000003
                    + self.rounds * 10007 + term * 101) & 0x7FFFFFFF

            bundles: List[Dict[str, Any]] = []
            contributors: List[str] = []
            skipped: List[str] = []
            updates_folded = 0
            # local contribution first (no transport, same code path)
            local = self._contribution(name, base_hash, salt)
            if local.get("sketch") is not None:
                bundles.append(local["sketch"])
                contributors.append(self.host_id)
                updates_folded += local.get("updates", 0)
            for p in self.reg.transport.peers():
                try:
                    r = self.reg.transport.send(
                        p, {"req": "merge_collect", "name": name,
                            "base_hash": base_hash, "term": term,
                            "salt": salt, "from": self.host_id})
                except TransportError:
                    skipped.append(p)           # unreachable: next round
                    continue
                if r.get("fenced"):
                    # a higher term exists: this leader is deposed — adopt
                    # it and abort with NO install anywhere
                    self.reg.observe_term(int(r["term"]), r.get("leader"))
                    raise MergeError(
                        f"merge_round({name!r}): fenced by term {r['term']} "
                        f"during collect — deposed; round aborted before "
                        f"any install (every contribution survives in its "
                        f"host's pending carry)")
                if not r.get("ok"):
                    skipped.append(p)
                    continue
                if r.get("sketch") is not None:
                    bundles.append(r["sketch"])
                    contributors.append(p)
                    updates_folded += r.get("updates", 0)
            report = {
                "name": name, "term": term, "base_hash": base_hash,
                "salt": salt,
                "contributors": contributors, "skipped": skipped,
                "updates_folded": updates_folded,
                "bytes_sketched": sum(compress.bundle_bytes(b)
                                      for b in bundles),
                "bytes_uncompressed":
                    compress.tree_bytes(base) * max(1, len(bundles)),
                "version": None,
            }
            if not bundles:
                report["wall_ms"] = self.service.clock.now() - t0
                return report                   # nothing staged fleet-wide

            # all-reduce in sketch space, one projection decode, then the
            # ordinary replicated install: push the merged state as a
            # "merge" op and flip it live through the two-phase quorum
            # promote (which re-fences leadership under _meta).
            delta = compress.merge_deltas(base, bundles, self.cfg, salt=salt)
            merged = compress.apply_delta(base, delta)
            version = self.reg.push_merged(
                name, merged, contributors=tuple(contributors))
            self.reg.promote(name, version)
            self.installs += 1
            report["version"] = version

            # commit: every contributor finalizes its carry (drop what was
            # installed, keep what the sketch missed).  Best-effort — a
            # dropped commit resolves at the host's next collect from the
            # durable merge-op log.
            self._finalize(name, salt)
            for p in self.reg.transport.peers():
                try:
                    self.reg.transport.send(
                        p, {"req": "merge_commit", "name": name,
                            "term": term, "salt": salt,
                            "from": self.host_id})
                except TransportError:
                    pass
            report["wall_ms"] = self.service.clock.now() - t0
            return report

    # ---- host side: collect / commit ---------------------------------------
    def handle(self, msg: Message) -> Message:
        """Routed here by `ReplicatedRegistry._handle` for merge requests
        (already term-fenced by `_check_term`)."""
        req = msg.get("req")
        if req == "merge_collect":
            return self._on_collect(msg)
        if req == "merge_commit":
            return self._on_commit(msg)
        return {"ok": False, "error": f"unknown merge request {req!r}"}

    def _on_collect(self, msg: Message) -> Message:
        name = msg["name"]
        reply = self._contribution(name, msg.get("base_hash"),
                                   int(msg.get("salt", 0)))
        # decide + reply fencing, the `prepare` pattern: a vote granted to
        # a higher-term candidate while the (unlocked) sketch math ran
        # must flip this answer to fenced — an ok is a promise to the OLD
        # leader's round
        fenced = self.reg.fence_if_stale(msg.get("term"))
        if fenced is not None:
            return fenced
        return reply

    def _on_commit(self, msg: Message) -> Message:
        outcome = self._finalize(msg["name"], int(msg.get("salt", 0)))
        return {"ok": True, "result": outcome}

    # ---- carry record state machine ----------------------------------------
    def _store_residual(self, name: str, rec: Dict[str, Any]) -> None:
        """Install a carry record and persist it through the registry WAL
        (fsync before the caller replies to anything).  The dict write is
        under the leaf lock; the durable append is under no lock."""
        with self._res_lock:
            self._residuals[name] = rec
        persist = getattr(self.reg, "persist_residual", None)
        if persist is not None:
            persist(name, rec)

    def _finalize(self, name: str, salt: int) -> str:
        """Commit outcome for the round identified by `salt`: the pending
        carry collapses to `final` (= v − Pv; the installed part is
        dropped).  A salt mismatch means the pending record belongs to a
        DIFFERENT round than this commit — leave it for the log-based
        resolution at the next collect rather than guessing."""
        with self._res_lock:
            rec = self._residuals.get(name)
        if rec is None or not rec["pending"]:
            return "noop"
        if int(rec["salt"]) != int(salt):
            return "stale"
        self._store_residual(name, _settled(rec["final"]))
        return "finalized"

    def _contribution(self, name: str, base_hash: Optional[str],
                      salt: int) -> Message:
        """Extract, sketch, and persist this host's contribution to a
        round against `base_hash`.  Returns `{"ok": True, "sketch": ...,
        "updates": n}` — `sketch` is None when there is nothing to
        contribute (no staged chain AND no carried signal)."""
        try:
            snap = self.reg.get(name)
        except KeyError:
            return {"ok": False, "error": f"unknown model {name!r}"}
        if base_hash is not None and \
                self.reg.version_hash(name, snap.version) != base_hash:
            # not on the round's base: catch up once, then re-check.  The
            # sync also pulls any merge/promote ops the next step needs.
            try:
                self.reg.sync()
            except (TransportError, ReplicationError):
                pass
            snap = self.reg.get(name)
            if self.reg.version_hash(name, snap.version) != base_hash:
                return {"ok": False, "not_on_base": True}

        # resolve a pending carry from an earlier round whose commit never
        # arrived (or that this host crashed through): the merge-op log is
        # the durable truth about whether that round's sketch went live
        with self._res_lock:
            rec = self._residuals.get(name)
        if rec is not None and rec["pending"]:
            landed = self.reg.merge_landed(name, int(rec["seq"]),
                                           self.host_id)
            rec = _settled(rec["final"] if landed else rec["carry"])
            self._store_residual(name, rec)
        carry = None if rec is None else rec["carry"]
        if carry is not None and not _ef_matches(carry, snap.state):
            carry = None            # register(replace=True): stale carry
        if carry is not None:
            carry = _placed(carry, snap.state)

        ext = self.service.extract_staged(name)
        if ext.staged is not None and ext.chain_base is not None:
            delta = _tree_delta(ext.staged, ext.chain_base)
        else:
            delta = None
        if delta is None:
            if carry is None or not compress.residual_nonzero(carry):
                return {"ok": True, "sketch": None, "updates": 0}
            v = carry               # nothing newly staged: flush the carry
        elif carry is None:
            v = delta
        else:
            v = _tree_add(delta, carry)

        # v is this host's entire un-installed signal.  Sketch it (no lock
        # held); WAL the pending record — both the outcome branches — and
        # fsync BEFORE acking the sketch to the leader.
        bundle, final = compress.delta_sketch(
            v, compress.residual_init(v), self.cfg, salt=salt,
            backend=_backend(snap.model))
        self._store_residual(name, {
            "carry": v, "final": final, "salt": int(salt),
            "seq": int(ext.seq), "pending": True})
        return {"ok": True, "sketch": bundle, "updates": ext.updates}
