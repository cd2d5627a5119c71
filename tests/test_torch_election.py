"""The port's leader election and fencing (`repro_torch.serve.election`),
test for test the twin of `tests/test_election.py`: term-numbered failover
on the deterministic `FleetHarness` (VirtualClock — no sleeps but in the two
real-clock tests), log-freshness vote grants, stale-leader fencing of
in-flight two-phase promotes, mutation re-routing to the elected leader,
the seeded chaos schedules (`--seed`), the kill-leader-mid-promote race
(CHAOS_ITERS-scaled), anti-entropy repair, the hypothesis safety property,
and threaded electors over TCP and on the monotonic clock.

`tests/conftest.py` arms its lock-order watch for `repro.serve` locks only,
so the chaos twins enter `harness.lock_order_watch` for the port's serve
modules themselves, before they build the fleet, and assert the observed
acquisition graph acyclic at the end."""

import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from harness import lock_order_watch
from repro_torch.serve import (DRService, Elector, LocalBus, ReplicatedRegistry,
                               ReplicationError, TCPTransport, TransportError)
from repro_torch.serve.replication import Op, state_hash

from torch_fleet_harness import FleetHarness, init_state, model_states as _states, small_model

pytestmark = pytest.mark.replication

PORT_SERVE = ("repro_torch.serve",)


def _fleet(n_hosts=3, timeouts=None, **kw):
    """Election-enabled fleet with pinned per-host timeouts (ms) so tests
    choose who campaigns first."""
    return FleetHarness(n_hosts=n_hosts, elect=True, election_timeouts=timeouts,
                        heartbeat_interval_ms=5.0, **kw)


def _blocks(seed, n, rows=4, m=32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, rows, m)).astype(np.float32))


class TestElectionBasics:
    def test_initial_fleet_is_agreed_on_static_leader(self):
        fleet = _fleet(timeouts=[40.0, 60.0, 80.0])
        assert fleet.pump_elections() == "h0"
        assert [r.term for r in fleet.registries] == [0, 0, 0]
        assert all(e.elections_started == 0 for e in fleet.electors)

    def test_heartbeats_prevent_spurious_elections(self):
        fleet = _fleet(timeouts=[40.0, 60.0, 80.0])
        for _ in range(100):
            fleet.clock.advance(4.0)
            for e in fleet.electors:
                e.poll()
        assert all(e.elections_started == 0 for e in fleet.electors)
        assert fleet.registry_for("h0").role == "leader"
        assert [r.term for r in fleet.registries] == [0, 0, 0]

    def test_kill_leader_elects_new_one_at_higher_term(self):
        fleet = _fleet(timeouts=[40.0, 60.0, 80.0])
        model, (s0,) = _states(1)
        fleet.register("m", model, s0)
        dead = fleet.kill_leader()
        assert dead == "h0"
        winner = fleet.pump_elections()
        assert winner in ("h1", "h2")
        lead = fleet.registry_for(winner)
        assert lead.role == "leader" and lead.term >= 1
        assert winner == "h1"

    def test_election_timeouts_are_seed_deterministic(self):
        a = Elector(ReplicatedRegistry(LocalBus().attach("x"), role="leader"), seed=7)
        b = Elector(ReplicatedRegistry(LocalBus().attach("x"), role="leader"), seed=7)
        c = Elector(ReplicatedRegistry(LocalBus().attach("x"), role="leader"), seed=8)
        assert a._timeout_ms == b._timeout_ms
        assert a._timeout_ms != c._timeout_ms

    def test_stale_log_candidate_cannot_win(self):
        fleet = _fleet(timeouts=[200.0, 60.0, 30.0])
        model, (s0, s1) = _states(2)
        fleet.register("m", model, s0)
        fleet.bus.partition("h2")
        fleet.leader.push("m", s1)
        fleet.bus.heal("h2")
        fleet.bus.partition("h0")
        winner = fleet.pump_elections()
        assert winner == "h1"
        h2 = fleet.electors[2]
        assert h2.elections_started >= 1 and h2.won_terms == []
        assert fleet.registry_for("h1").term > h2.status()["term"] - 1
        assert fleet.registry_for("h1").n_versions("m") == 2

    def test_leader_status_surfaces_through_the_service(self):
        fleet = _fleet(timeouts=[40.0, 60.0, 80.0])
        st = fleet.services[1].leader_status()
        assert (st["role"], st["leader"], st["term"]) == ("follower", "h0", 0)
        fleet.kill_leader()
        winner = fleet.pump_elections()
        st = fleet.service_for(winner).leader_status()
        assert st["role"] == "leader" and st["leader"] == winner
        assert st["term"] >= 1
        svc = DRService()
        assert svc.leader_status()["role"] == "leader"

    def test_mutations_forward_to_elected_leader(self):
        fleet = _fleet(timeouts=[40.0, 60.0, 80.0])
        model, (s0, s1) = _states(2)
        fleet.register("m", model, s0)
        dead = fleet.kill_leader()
        winner = fleet.pump_elections()
        other = next(h for h in ("h1", "h2") if h != winner)
        reg = fleet.registry_for(other)
        v = reg.push("m", s1)
        assert reg.promote("m", v) == v
        live = fleet.live_versions("m")
        assert [live[fleet.host_ids().index(h)] for h in ("h1", "h2")] == [v, v]
        fleet.heal(dead)
        fleet.pump_elections()
        old = fleet.registry_for(dead)
        assert old.role == "follower"
        old.sync()
        assert fleet.converged("m")

    def test_static_fleet_contract_unchanged(self):
        fleet = FleetHarness(n_hosts=2)
        model, (s0, s1) = _states(2)
        fleet.register("m", model, s0)
        with pytest.raises(ReplicationError, match="read replicas"):
            fleet.registries[1].push("m", s1)


class TestFencing:
    def test_deposed_leader_promote_is_fenced_fleet_wide(self):
        fleet = _fleet(timeouts=[500.0, 60.0, 30.0], quorum=2)
        model, (s0,) = _states(1)
        fleet.register("m", model, s0)
        svc = fleet.services[0]
        for blk in _blocks(2, 4):
            svc.serve_and_update("m", blk)
        staged_hash = state_hash(svc.staged_state("m"))

        fleet.bus.partition("h2")
        prepares = []

        def cut_leader_mid_promote(src, dst, msg):
            if msg.get("req") == "prepare":
                prepares.append((src, dst))
                fleet.bus.partition("h0")
                return False
            return True

        fleet.bus.intercept = cut_leader_mid_promote
        try:
            with pytest.raises(ReplicationError, match="aborted before"):
                svc.promote("m")
        finally:
            fleet.bus.intercept = None
        assert prepares, "promote never reached phase 1"
        assert svc.staged_state("m") is not None
        assert fleet.leader.n_versions("m") == 2
        assert fleet.live_versions("m") == [0, 0, None] or \
            fleet.live_versions("m") == [0, 0, 0]

        fleet.bus.heal("h2")
        winner = fleet.pump_elections()
        assert winner == "h1"
        new_term = fleet.registry_for("h1").term
        assert new_term >= 2
        assert fleet.electors[2].won_terms == []

        fleet.bus.heal("h0")
        with pytest.raises(ReplicationError, match="fenced"):
            svc.promote("m")
        old = fleet.registry_for("h0")
        assert old.role == "follower" and old.leader == "h1"
        assert old.term == new_term
        assert svc.staged_state("m") is not None

        v = svc.promote("m")
        assert fleet.live_versions("m") == [v, v, v]
        want = state_hash(fleet.registry_for("h1").state("m", v))
        assert want == staged_hash
        for reg in fleet.registries:
            assert state_hash(reg.get("m").state) == want

    def test_apply_and_prepare_recheck_term_atomically(self):
        fleet = _fleet(timeouts=[40.0, 60.0, 80.0])
        model, (s0, s1) = _states(2)
        fleet.register("m", model, s0)
        follower = fleet.registries[1]
        follower.observe_term(7)
        op = Op(seq=1, kind="push", name="m", version=1, state_hash="feed", term=0)
        with pytest.raises(ReplicationError, match="stale"):
            follower._apply(op, {"feed": s1}, sender_term=0)
        assert follower.applied_seq("m") == 0
        reply = follower._handle_prepare({"name": "m", "version": 0, "hash": None, "term": 0})
        assert reply == {"ok": False, "fenced": True, "term": 7, "leader": "h0"}
        assert follower._apply(op, {"feed": s1}, sender_term=7) is True

    def test_sync_reply_from_stale_leader_is_fenced(self):
        fleet = _fleet(timeouts=[40.0, 60.0, 80.0])
        model, (s0, s1) = _states(2)
        fleet.register("m", model, s0)
        fleet.bus.partition("h1")
        fleet.leader.push("m", s1)
        fleet.bus.heal("h1")
        follower = fleet.registries[1]
        follower.observe_term(7)
        with pytest.raises(ReplicationError, match="stale"):
            follower.sync()
        assert follower.n_versions("m") == 1

    def test_fenced_heartbeat_deposes_returned_leader(self):
        fleet = _fleet(timeouts=[40.0, 60.0, 80.0])
        dead = fleet.kill_leader()
        fleet.pump_elections()
        fleet.heal(dead)
        old_elector = fleet.electors[0]
        fleet.clock.advance(5.0)
        old_elector.poll()
        assert fleet.registry_for(dead).role == "follower"
        assert old_elector.status()["state"] == "follower"

    def test_uncommitted_suffix_is_rewound_by_divergence_reset(self):
        fleet = _fleet(timeouts=[500.0, 60.0, 80.0], quorum=1)
        model, (s0, s1, s2) = _states(3)
        fleet.register("m", model, s0)
        fleet.bus.partition("h0")
        fleet.leader.push("m", s1)
        fleet.leader.promote("m", 1)
        assert fleet.leader.get("m").version == 1
        winner = fleet.pump_elections()
        new_lead = fleet.registry_for(winner)
        v = new_lead.push("m", s2)
        new_lead.promote("m", v)
        fleet.bus.heal("h0")
        fleet.clock.advance(5.0)
        fleet.electors[fleet.host_ids().index(winner)].poll()
        old = fleet.registry_for("h0")
        assert old.role == "follower"
        pre_adopt_reads = []
        orig_adopt = old.local.adopt

        def spying_adopt(name, shadow):
            pre_adopt_reads.append(old.get("m").version)
            orig_adopt(name, shadow)

        old.local.adopt = spying_adopt
        try:
            old.sync()
        finally:
            old.local.adopt = orig_adopt
        assert pre_adopt_reads == [1]
        assert fleet.converged("m")
        assert state_hash(old.get("m").state) == state_hash(s2)
        assert old.applied_seq("m") == new_lead.applied_seq("m")

    def test_phantom_register_is_dropped_and_unblocks_elections(self):
        fleet = _fleet(timeouts=[500.0, 60.0, 80.0])
        model, (s0, s1) = _states(2)
        fleet.register("m", model, s0)
        fleet.bus.partition("h0")
        fleet.leader.register("ghost", model, s1)
        assert "ghost" in fleet.leader
        winner = fleet.pump_elections()
        assert winner == "h1"
        fleet.heal()
        fleet.clock.advance(5.0)
        fleet.electors[1].poll()
        old = fleet.registry_for("h0")
        assert old.role == "follower"
        old.sync()
        assert "ghost" not in old
        assert set(old.log_summary()) == {"m"}
        fleet.bus.partition("h1")
        second = fleet.pump_elections()
        assert second == "h2"
        assert fleet.registry_for("h2").term > fleet.registry_for("h1").term \
            or fleet.registry_for("h2").role == "leader"


# ---------------------------------------------------------------------------
# chaos: seeded random schedules (--seed N)
# ---------------------------------------------------------------------------

def _committed_survives(fleet, attempts):
    fleet.heal()
    winner = fleet.pump_elections()
    for reg in fleet.registries:
        if reg.transport.host_id != winner:
            reg.sync()
    assert fleet.converged("m"), fleet.live_versions("m")
    final = state_hash(fleet.registries[0].get("m").state)
    committed = [i for i, (_, ok) in enumerate(attempts) if ok]
    if not committed:
        return
    allowed = {h for h, _ in attempts[committed[-1]:]}
    assert final in allowed, (final, attempts)


def _assert_one_leader_per_term(fleet):
    seen = {}
    for e in fleet.electors:
        for t in e.won_terms:
            assert t not in seen, f"term {t} won by both {seen[t]} and {e.host_id}"
            seen[t] = e.host_id


@pytest.mark.chaos
def test_chaos_random_partition_schedule(chaos_seed):
    with lock_order_watch(prefixes=PORT_SERVE) as watch:
        rng = np.random.RandomState(1000 + chaos_seed)
        fleet = _fleet(timeouts=None, seed=chaos_seed)
        model, states = _states(6, start=chaos_seed * 10)
        fleet.register("m", model, states[0])
        attempts = []
        hosts = fleet.host_ids()
        for step in range(12):
            action = rng.randint(4)
            if action == 0:
                live = [h for h in hosts if h not in fleet.bus.partitioned()]
                if len(live) > 2:
                    fleet.bus.partition(live[rng.randint(len(live))])
            elif action == 1:
                fleet.heal()
            elif action == 2:
                try:
                    fleet.pump_elections(max_ms=20_000.0)
                except AssertionError:
                    pass
            else:
                st = states[rng.randint(1, len(states))]
                lead = fleet.current_leader()
                if lead is None:
                    continue
                h = state_hash(st)
                try:
                    v = lead.push("m", st)
                    lead.promote("m", v)
                    attempts.append((h, True))
                except (ReplicationError, TransportError):
                    attempts.append((h, False))
        _assert_one_leader_per_term(fleet)
        _committed_survives(fleet, attempts)
    assert watch.graph.acquisitions > 0
    watch.assert_acyclic()


@pytest.mark.chaos
def test_kill_leader_mid_promote_race(chaos_seed):
    iters = int(os.environ.get("CHAOS_ITERS", "5"))
    rng = np.random.RandomState(2000 + chaos_seed)
    model = small_model()
    with lock_order_watch(prefixes=PORT_SERVE) as watch:
        for it in range(iters):
            fleet = _fleet(timeouts=[500.0, 40.0, 60.0], quorum=2)
            s0 = init_state(model, chaos_seed * 1000 + it)
            fleet.register("m", model, s0)
            svc = fleet.services[0]
            for blk in _blocks(3000 + chaos_seed * 100 + it, 2):
                svc.serve_and_update("m", blk)
            staged_hash = state_hash(svc.staged_state("m"))
            kill_at = rng.randint(1, 5)
            seen = [0]

            def cut(src, dst, msg, seen=seen, kill_at=kill_at, fleet=fleet):
                if src == "h0" and msg.get("req") in ("op", "prepare"):
                    seen[0] += 1
                    if seen[0] >= kill_at:
                        fleet.bus.partition("h0")
                        return False
                return True

            fleet.bus.intercept = cut
            committed = False
            try:
                svc.promote("m")
                committed = True
            except ReplicationError:
                pass
            finally:
                fleet.bus.intercept = None
            fleet.bus.partition("h0")
            winner = fleet.pump_elections()
            assert winner in ("h1", "h2")
            fleet.heal()
            old = fleet.registry_for("h0")
            if not committed:
                assert svc.staged_state("m") is not None
                try:
                    v = svc.promote("m")
                except ReplicationError:
                    v = svc.promote("m")
            else:
                old.sync()
                v = old.get("m").version
            for reg in fleet.registries:
                if reg.role != "leader":
                    reg.sync()
            assert fleet.converged("m"), (it, fleet.live_versions("m"))
            assert state_hash(old.get("m").state) == staged_hash, it
            _assert_one_leader_per_term(fleet)
    assert watch.graph.acquisitions > 0
    watch.assert_acyclic()


# ---------------------------------------------------------------------------
# hypothesis: election safety as a property
# ---------------------------------------------------------------------------

try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as hst
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    _EVENT = hst.one_of(
        hst.tuples(hst.just("partition"), hst.integers(0, 2)),
        hst.tuples(hst.just("heal"), hst.just(0)),
        hst.tuples(hst.just("elect"), hst.just(0)),
        hst.tuples(hst.just("promote"), hst.integers(1, 3)),
    )

    @settings(max_examples=15, deadline=None,
              suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
    @given(events=hst.lists(_EVENT, max_size=10))
    def test_property_one_leader_per_term_and_committed_promotes_survive(events):
        fleet = _fleet(timeouts=None, seed=17)
        model, states = _states(4)
        fleet.register("m", model, states[0])
        attempts = []
        hosts = fleet.host_ids()
        for kind, arg in events:
            if kind == "partition":
                live = [h for h in hosts if h not in fleet.bus.partitioned()]
                if len(live) > 2:
                    fleet.bus.partition(live[arg % len(live)])
            elif kind == "heal":
                fleet.heal()
            elif kind == "elect":
                try:
                    fleet.pump_elections(max_ms=20_000.0)
                except AssertionError:
                    pass
            else:
                lead = fleet.current_leader()
                if lead is None:
                    continue
                st = states[arg]
                h = state_hash(st)
                try:
                    v = lead.push("m", st)
                    lead.promote("m", v)
                    attempts.append((h, True))
                except (ReplicationError, TransportError):
                    attempts.append((h, False))
        _assert_one_leader_per_term(fleet)
        _committed_survives(fleet, attempts)


# ---------------------------------------------------------------------------
# threaded electors on the real clock
# ---------------------------------------------------------------------------

def test_tcp_electors_failover_with_capped_rpc_timeouts():
    ts = [TCPTransport(f"h{i}") for i in range(3)]
    for t in ts:
        for u in ts:
            if t is not u:
                t.add_peer(u.host_id, u.address)
    leader = ReplicatedRegistry(ts[0], role="leader")
    f1 = ReplicatedRegistry(ts[1], role="follower", leader="h0", sync_on_start=False)
    f2 = ReplicatedRegistry(ts[2], role="follower", leader="h0", sync_on_start=False)
    model, (s0, s1) = _states(2)
    leader.register("m", model, s0)
    electors = [Elector(r, seed=i).start() for i, r in enumerate([leader, f1, f2])]
    try:
        electors[0].close()
        ts[0].close()
        deadline = time.monotonic() + 60.0
        new = None
        while time.monotonic() < deadline and new is None:
            new = next((r for r in (f1, f2) if r.role == "leader"), None)
            time.sleep(0.01)
        assert new is not None, [e.status() for e in electors[1:]]
        assert new.term >= 1
        v = None
        while time.monotonic() < deadline and v is None:
            try:
                v = new.promote("m", new.push("m", s1))
            except ReplicationError:
                time.sleep(0.02)
        other = f2 if new is f1 else f1
        assert v is not None
        assert other.get("m").version == v
        assert state_hash(other.get("m").state) == state_hash(s1)
    finally:
        for e in electors[1:]:
            e.close()
        for t in ts[1:]:
            t.close()


def test_threaded_electors_on_monotonic_clock_elect_after_kill():
    bus = LocalBus()
    leader = ReplicatedRegistry(bus.attach("h0"), role="leader")
    f1 = ReplicatedRegistry(bus.attach("h1"), role="follower", leader="h0")
    f2 = ReplicatedRegistry(bus.attach("h2"), role="follower", leader="h0")
    regs = [leader, f1, f2]
    electors = [Elector(r, seed=i, election_timeout_ms=(50.0, 100.0),
                        heartbeat_interval_ms=10.0).start()
                for i, r in enumerate(regs)]
    try:
        model, (s0,) = _states(1)
        leader.register("m", model, s0)
        bus.partition("h0")
        done = threading.Event()
        t0 = time.monotonic()
        while time.monotonic() - t0 < 30.0:
            if any(r.role == "leader" for r in (f1, f2)):
                done.set()
                break
            time.sleep(0.01)
        assert done.is_set(), [e.status() for e in electors]
        new_lead = f1 if f1.role == "leader" else f2
        assert new_lead.term >= 1
        assert new_lead.n_versions("m") == 1
    finally:
        for e in electors:
            e.close()
