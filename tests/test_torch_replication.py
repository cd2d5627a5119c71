"""The port's registry replication (`repro_torch.serve.replication` over
`repro_torch.serve.transport`), test for test the twin of
`tests/test_replication.py`: the content-addressed op log, LocalBus fleet
semantics, the two-phase atomic fleet-wide promote, quorum aborts under
partition, anti-entropy catch-up for missed ops and late joiners, a stopped
TCP member, and the multi-process TCP fleet (subprocesses on the CPU).

On top of the twins, what is the port's own: a transport refuses a message
holding a tensor that is not on the host, each host serves a device copy
of every version made once at install (the same tensor objects on every
`get()`), and `model_config_hash` folds in the device's type, not its
string."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tree_mod
from repro_torch.core.execution import Execution
from repro_torch.serve import (DRService, LocalBus, ReplicatedRegistry, ReplicationError,
                               TCPTransport, TransportError)
from repro_torch.serve import registry as tregistry
from repro_torch.serve.replication import Op, host_state, state_hash

from torch_fleet_harness import FleetHarness, init_state, model_states as _states, small_model

pytestmark = pytest.mark.replication


def _x(rows, seed=0, m=32):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((rows, m)).astype(np.float32))


def _close(got, want, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


class TestStateHash:
    def test_deterministic_and_content_addressed(self):
        model, (s0, s1) = _states(2)
        assert state_hash(s0) == state_hash(s0)
        assert state_hash(s0) == state_hash(host_state(s0))
        numpy_leaves = tree_mod.unflatten(s0, [t.numpy() for t in tree_mod.leaves(s0)])
        assert state_hash(s0) == state_hash(numpy_leaves)       # torch == numpy
        assert state_hash(s0) != state_hash(s1)

    def test_sensitive_to_single_element(self):
        model, (s0,) = _states(1)
        leaves = tree_mod.leaves(s0)
        bumped = [leaves[0] + 1e-3] + leaves[1:]
        assert state_hash(s0) != state_hash(tree_mod.unflatten(s0, bumped))


class TestLocalBus:
    def test_partition_and_heal(self):
        bus = LocalBus()
        a, b = bus.attach("a"), bus.attach("b")
        b.set_handler(lambda msg: {"ok": True, "echo": msg["x"]})
        assert a.send("b", {"x": 1}) == {"ok": True, "echo": 1}
        bus.partition("b")
        with pytest.raises(TransportError):
            a.send("b", {"x": 2})
        bus.heal()
        assert a.send("b", {"x": 3})["echo"] == 3
        with pytest.raises(TransportError):
            a.send("ghost", {})
        assert a.peers() == ("b",)

    def test_intercept_can_drop(self):
        bus = LocalBus()
        a, b = bus.attach("a"), bus.attach("b")
        b.set_handler(lambda msg: {"ok": True})
        bus.intercept = lambda src, dst, msg: msg.get("keep", True)
        assert a.send("b", {"keep": True})["ok"]
        with pytest.raises(TransportError):
            a.send("b", {"keep": False})
        assert bus.dropped == 1

    def test_refuses_tensors_off_the_host(self):
        """Whatever crosses a transport is a host copy: a tensor on a device
        (here the meta device, which this CPU has) is refused at `send`, in
        a request or in a reply, before anything is delivered."""
        model, (s0,) = _states(1)
        bus = LocalBus()
        a, b = bus.attach("a"), bus.attach("b")
        b.set_handler(lambda msg: {"ok": True, "state": msg.get("reply")})
        off_host = s0._replace(stages=(s0.stages[0], s0.stages[1].to("meta")))
        with pytest.raises(ValueError, match=r"host copies only.*\.stages\[1\]"):
            a.send("b", {"payloads": {"h": off_host}})
        assert bus.sent == 0
        with pytest.raises(ValueError, match="host copies only"):
            a.send("b", {"reply": [torch.zeros(2, device="meta")]})
        assert a.send("b", {"reply": host_state(s0)})["ok"]
        t = TCPTransport("t")
        try:
            t.add_peer("a", ("127.0.0.1", 1))
            with pytest.raises(ValueError, match="host copies only"):
                t.send("a", {"state": off_host})
        finally:
            t.close()


class TestOpLog:
    def test_replay_is_idempotent(self):
        fleet = FleetHarness(n_hosts=2)
        model, (s0, s1) = _states(2)
        fleet.register("m", model, s0)
        fleet.leader.push("m", s1)
        follower = fleet.registries[1]
        op = follower._log["m"][-1]
        st = follower._states[op.state_hash]
        assert follower._apply(op, {op.state_hash: st}) is False   # replayed
        assert follower.n_versions("m") == 2                       # unchanged

    def test_gap_raises_sync_required(self):
        follower = ReplicatedRegistry(LocalBus().attach("h1"), role="follower",
                                      leader="h0", sync_on_start=False)
        model, (s0,) = _states(1)
        st = host_state(s0)
        with pytest.raises(ReplicationError, match="sync required"):
            follower._apply(Op(seq=3, kind="push", name="m", version=1,
                               state_hash=state_hash(st)), {})

    def test_pull_bundle_skips_held_hashes(self):
        fleet = FleetHarness(n_hosts=1)
        model, (s0, s1) = _states(2)
        fleet.register("m", model, s0)
        fleet.leader.push("m", s1)
        h0 = state_hash(s0)
        full = fleet.leader._pull_bundle({}, [])
        assert len(full["ops"]["m"]) == 2
        assert set(full["payloads"]) == {h0, state_hash(s1)}
        partial = fleet.leader._pull_bundle({}, [h0])
        assert len(partial["ops"]["m"]) == 2
        assert set(partial["payloads"]) == {state_hash(s1)}


class TestBundleTermFence:
    def test_stale_term_bundle_cannot_phantom_drop(self):
        fleet = FleetHarness(n_hosts=1)
        model, (s0,) = _states(1)
        fleet.register("m", model, s0)
        reg = fleet.leader
        reg.observe_term(5)
        stale = {"ops": {}, "payloads": {}, "reset": ["m"], "term": 3}
        with pytest.raises(ReplicationError, match="rejected"):
            reg._ingest_bundle(stale)
        assert "m" in reg.local.names()
        fresh = {"ops": {}, "payloads": {}, "reset": ["m"], "term": 5}
        assert reg._ingest_bundle(fresh) == 0
        assert "m" not in reg.local.names()

    def test_termless_bundle_is_not_fenced(self):
        fleet = FleetHarness(n_hosts=1)
        model, (s0,) = _states(1)
        fleet.register("m", model, s0)
        reg = fleet.leader
        reg.observe_term(5)
        reg._ingest_bundle({"ops": {}, "payloads": {}, "reset": ["m"]})
        assert "m" not in reg.local.names()


class TestFleetReplication:
    def test_register_replicates_everywhere(self):
        fleet = FleetHarness(n_hosts=3)
        model, (s0,) = _states(1)
        fleet.register("m", model, s0)
        assert fleet.live_versions("m") == [0, 0, 0]
        x = _x(5)
        want = model.transform(s0, x)
        for svc in fleet.services:
            _close(svc.transform("m", x), want)

    def test_push_is_not_live_until_promote(self):
        fleet = FleetHarness(n_hosts=3)
        model, (s0, s1) = _states(2)
        fleet.register("m", model, s0)
        v = fleet.leader.push("m", s1)
        assert v == 1
        assert all(r.n_versions("m") == 2 for r in fleet.registries)
        assert fleet.live_versions("m") == [0, 0, 0]
        assert fleet.leader.promote("m") == 1
        assert fleet.live_versions("m") == [1, 1, 1]

    def test_two_phase_promote_is_atomic(self):
        fleet = FleetHarness(n_hosts=3)
        model, (s0, s1) = _states(2)
        fleet.register("m", model, s0)
        x = _x(5, seed=7)
        y_old = fleet.services[0].transform("m", x).numpy()
        for svc in fleet.services[1:]:
            svc.transform("m", x)
        v = fleet.leader.push("m", s1)
        y_new = model.transform(s1, x).numpy()

        prepare_samples, commit_samples = [], []

        def spy(src, dst, msg):
            if msg.get("req") == "prepare":
                prepare_samples.append(fleet.live_versions("m"))
            elif msg.get("req") == "op" and msg["op"].kind == "promote":
                commit_samples.append(fleet.live_versions("m"))
            return True

        errors = []
        stop = threading.Event()

        def reader(svc):
            try:
                while not stop.is_set():
                    y = svc.transform("m", x).numpy()
                    if not (np.allclose(y, y_old, atol=1e-6)
                            or np.allclose(y, y_new, atol=1e-6)):
                        errors.append("torn read")
                        return
            except Exception as e:                     # noqa: BLE001
                errors.append(repr(e))

        threads = [threading.Thread(target=reader, args=(svc,)) for svc in fleet.services]
        for t in threads:
            t.start()
        fleet.bus.intercept = spy
        try:
            assert fleet.leader.promote("m", v) == v
        finally:
            fleet.bus.intercept = None
            stop.set()
            for t in threads:
                t.join(30.0)

        assert not errors, errors
        assert prepare_samples and all(s == [0, 0, 0] for s in prepare_samples), \
            prepare_samples
        assert commit_samples and all(set(s) <= {0, 1} for s in commit_samples), \
            commit_samples
        assert fleet.live_versions("m") == [1, 1, 1]

    def test_promote_without_quorum_aborts_with_no_flip(self):
        fleet = FleetHarness(n_hosts=3)
        model, (s0, s1) = _states(2)
        fleet.register("m", model, s0)
        v = fleet.leader.push("m", s1)
        fleet.bus.partition("h1", "h2")
        with pytest.raises(ReplicationError, match="aborted before any flip"):
            fleet.leader.promote("m", v)
        assert fleet.live_versions("m") == [0, 0, 0]
        fleet.bus.heal()
        assert fleet.leader.promote("m", v) == v
        assert fleet.live_versions("m") == [1, 1, 1]

    def test_prepare_checks_content_not_version_count(self):
        fleet = FleetHarness(n_hosts=2, quorum=2)
        model, (s0, s1) = _states(2)
        fleet.register("m", model, s0)
        fleet.leader.push("m", s1)
        fleet.bus.partition("h1")
        other = small_model(n=4)
        fleet.register("m", other, init_state(other, 3), replace=True)
        s2 = init_state(other, 4)
        fleet.leader.push("m", s2)
        fleet.bus.heal()
        assert fleet.leader.promote("m", 1) == 1
        assert fleet.live_versions("m") == [1, 1]
        follower = fleet.registries[1]
        assert state_hash(follower.state("m", 1)) == state_hash(s2)
        assert follower.get("m").model.stages[-1].n == 4

    def test_aborted_fleet_promote_keeps_staged_updates(self):
        fleet = FleetHarness(n_hosts=3, quorum=3)
        model, (s0,) = _states(1)
        fleet.register("m", model, s0)
        svc = fleet.services[0]
        blocks = _x(16, seed=2).reshape(4, 4, 32)
        for blk in blocks[:2]:
            svc.serve_and_update("m", blk)
        fleet.bus.partition("h2")
        with pytest.raises(ReplicationError):
            svc.promote("m")
        assert svc.staged_state("m") is not None
        assert fleet.leader.n_versions("m") == 2
        fleet.bus.heal()
        assert svc.promote("m") == 1
        assert fleet.leader.n_versions("m") == 2
        for blk in blocks[2:]:
            svc.serve_and_update("m", blk)
        v = svc.promote("m")
        assert v == 2
        manual = s0
        for blk in blocks:
            manual = model.update(manual, blk)
        for a, b in zip(tree_mod.leaves(fleet.leader.get("m").state),
                        tree_mod.leaves(manual)):
            np.testing.assert_allclose(a.numpy().astype(np.float64),
                                       b.numpy().astype(np.float64), rtol=1e-5, atol=1e-6)
        assert fleet.live_versions("m") == [v, v, v]

    def test_quorum_is_configurable(self):
        fleet = FleetHarness(n_hosts=3, quorum=1)
        model, (s0, s1) = _states(2)
        fleet.register("m", model, s0)
        v = fleet.leader.push("m", s1)
        fleet.bus.partition("h1", "h2")
        assert fleet.leader.promote("m", v) == v
        assert fleet.live_versions("m") == [1, 0, 0]
        fleet.bus.heal()
        for reg in fleet.registries[1:]:
            reg.sync()
        assert fleet.live_versions("m") == [1, 1, 1]

    def test_missed_op_heals_on_next_broadcast(self):
        fleet = FleetHarness(n_hosts=2)
        model, (s0, s1, s2) = _states(3)
        fleet.register("m", model, s0)
        fleet.bus.partition("h1")
        fleet.leader.push("m", s1)
        fleet.bus.heal()
        fleet.leader.push("m", s2)
        follower = fleet.registries[1]
        assert follower.n_versions("m") == 3
        assert follower.applied_seq("m") == 2
        assert state_hash(follower.state("m", 1)) == state_hash(s1)
        assert state_hash(follower.state("m", 2)) == state_hash(s2)

    def test_rollback_replicates(self):
        fleet = FleetHarness(n_hosts=3)
        model, (s0, s1) = _states(2)
        fleet.register("m", model, s0)
        assert fleet.push_promote("m", s1) == 1
        assert fleet.live_versions("m") == [1, 1, 1]
        assert fleet.leader.rollback("m") == 0
        assert fleet.live_versions("m") == [0, 0, 0]

    def test_replace_register_replicates(self):
        fleet = FleetHarness(n_hosts=2)
        model, (s0,) = _states(1)
        fleet.register("m", model, s0)
        other = small_model(n=4)
        s_other = init_state(other, 9)
        with pytest.raises(ValueError, match="replace=True"):
            fleet.register("m", other, s_other)
        fleet.register("m", other, s_other, replace=True)
        for reg in fleet.registries:
            snap = reg.get("m")
            assert snap.version == 0
            assert snap.model.stages[-1].n == 4

    def test_follower_mutation_raises(self):
        fleet = FleetHarness(n_hosts=2)
        model, (s0, s1) = _states(2)
        fleet.register("m", model, s0)
        follower = fleet.registries[1]
        with pytest.raises(ReplicationError, match="read replicas"):
            follower.push("m", s1)
        with pytest.raises(ReplicationError, match="read replicas"):
            follower.promote("m")
        with pytest.raises(ReplicationError, match="read replicas"):
            follower.register("m2", model, s1)

    def test_late_joiner_converges_via_anti_entropy(self):
        fleet = FleetHarness(n_hosts=2)
        model, (s0, s1, s2) = _states(3)
        fleet.register("m", model, s0)
        fleet.push_promote("m", s1)
        fleet.leader.push("m", s2)
        late = fleet.join_host("h9")
        assert fleet.live_versions("m") == [1, 1, 1]
        joined = fleet.registries[-1]
        assert joined.n_versions("m") == 3
        assert joined.applied_seq("m") == fleet.leader.applied_seq("m")
        for v in range(3):
            assert state_hash(joined.state("m", v)) == state_hash(fleet.leader.state("m", v))
        x = _x(6, seed=3)
        _close(late.transform("m", x), fleet.services[0].transform("m", x))
        assert fleet.leader.promote("m") == 2
        assert fleet.live_versions("m") == [2, 2, 2]


class TestInstalledCopies:
    """The port's own rule: a host serves a copy of each version installed
    once, never the caller's tensors nor the content store's host copy."""

    def test_every_get_hands_back_the_install_time_tensors(self):
        fleet = FleetHarness(n_hosts=3)
        model, (s0, s1) = _states(2)
        fleet.register("m", model, s0)
        fleet.push_promote("m", s1)
        for reg in fleet.registries:
            a, b = reg.get("m").state, reg.get("m").state
            assert all(x is y for x, y in zip(a.stages, b.stages))
            held = reg._states[state_hash(s1)]
            assert all(x is not y and x.data_ptr() != y.data_ptr()
                       for x, y in zip(a.stages, held.stages))
            assert all(x.data_ptr() != y.data_ptr() for x, y in zip(a.stages, s1.stages))
            assert state_hash(a) == state_hash(s1)

    def test_in_place_write_to_a_served_copy_leaves_the_log_intact(self):
        """Writing a host's served B in place (as a caller may) changes what
        that host serves and nothing the fleet ships or hashes."""
        fleet = FleetHarness(n_hosts=2)
        model, (s0,) = _states(1)
        fleet.register("m", model, s0)
        served = fleet.registries[1].get("m").state
        served.stages[1].mul_(2.0)
        assert state_hash(fleet.registries[1]._states[state_hash(s0)]) == state_hash(s0)
        late = fleet.join_host("h9")
        _close(late.transform("m", _x(3)), model.transform(s0, _x(3)))


class TestConfigHashDevice:
    def test_cuda_and_cuda0_hash_alike(self):
        """Built without resolving the device (no card here): the hash
        takes the device's type, so two hosts naming one card differently
        register the same config."""
        a = small_model(device="cuda")
        b = small_model(device="cuda:0")
        assert a.execution != b.execution
        assert tregistry.model_config_hash(a) == tregistry.model_config_hash(b)

    def test_cpu_and_cuda_differ(self):
        assert tregistry.model_config_hash(small_model(device="cpu")) != \
            tregistry.model_config_hash(small_model(device="cuda"))
        assert tregistry.model_config_hash(small_model(device="cpu")) != \
            tregistry.model_config_hash(small_model(backend="torch"))

    def test_execution_alone_normalises_too(self):
        assert Execution(device="cuda:0") != Execution(device="cuda")
        model = small_model(device="cuda")

        class Bare:                     # a model without with_execution
            execution = Execution(device="cuda:0")

            def __repr__(self):
                return "Bare()"

        class Bare2(Bare):
            execution = Execution(device="cuda")

            def __repr__(self):
                return "Bare()"

        assert tregistry.model_config_hash(Bare()) == tregistry.model_config_hash(Bare2())
        assert tregistry.model_config_hash(model) != tregistry.model_config_hash(Bare())


class TestFleetServing:
    def test_every_host_serves_through_its_own_engine(self):
        fleet = FleetHarness(n_hosts=3)
        model, (s0,) = _states(1)
        fleet.register("m", model, s0)
        xs = [_x(r, seed=r) for r in (3, 9, 17)]
        for svc in fleet.services:
            tickets = [svc.submit("m", x) for x in xs]
            svc.flush()
            for t, x in zip(tickets, xs):
                _close(t.result(), model.transform(s0, x))

    def test_train_while_serve_promote_goes_fleet_wide(self):
        fleet = FleetHarness(n_hosts=3)
        model, (s0,) = _states(1)
        fleet.register("m", model, s0)
        leader_svc = fleet.services[0]
        x = _x(32, seed=5)
        for blk in x.reshape(8, 4, 32):
            leader_svc.serve_and_update("m", blk)
        v = leader_svc.promote("m")
        assert v == 1 and fleet.live_versions("m") == [1, 1, 1]
        fitted = model.fit(s0, x, epochs=1)
        want = model.transform(fitted, x[:6])
        for svc in fleet.services:
            _close(svc.transform("m", x[:6]), want, rtol=1e-5, atol=1e-6)
        leader_svc.rollback("m")
        assert fleet.live_versions("m") == [0, 0, 0]


class TestTCPDeadPeer:
    def test_stopped_member_counts_as_unreachable_nack(self):
        t0 = TCPTransport("h0")
        t1 = TCPTransport("h1")
        t2 = TCPTransport("h2")
        transports = [t0, t1, t2]
        for t in transports:
            for u in transports:
                if t is not u:
                    t.add_peer(u.host_id, u.address)
        try:
            leader = ReplicatedRegistry(t0, role="leader")
            f1 = ReplicatedRegistry(t1, role="follower", leader="h0")
            f2 = ReplicatedRegistry(t2, role="follower", leader="h0")
            model, (s0, s1) = _states(2)
            leader.register("m", model, s0)
            assert f1.get("m").version == 0 and f2.get("m").version == 0

            served_before_stop = f2.applied_seq("m")
            t2.close()

            v = leader.push("m", s1)
            assert leader.promote("m", v) == v
            assert leader.get("m").version == v
            assert f1.get("m").version == v
            assert f2.applied_seq("m") == served_before_stop
            fs = leader.fleet_status()
            assert set(fs) == {"h0", "h1"}
            assert all(s["live"]["m"] == v for s in fs.values())
        finally:
            for t in transports:
                t.close()


TCP_FLEET_SCRIPT = r'''
import sys, time
import numpy as np, torch
from repro_torch import dr
from repro_torch.serve import DRService, ReplicatedRegistry, TCPTransport
from repro_torch.serve.replication import state_hash

def model():
    return dr.DRModel(stages=(dr.RPStage(16, 8), dr.EASIStage.rotation(8, 4, mu=1e-3)),
                      execution=dr.Execution(backend="kernel", device="cpu"), block_size=4)

if sys.argv[1] == "follower":
    hid, host, port = sys.argv[2], sys.argv[3], int(sys.argv[4])
    t = TCPTransport(hid)
    t.add_peer("h0", (host, port))
    reg = ReplicatedRegistry(t, role="follower", leader="h0", sync_on_start=False)
    reg.join()
    deadline = time.time() + 120.0
    while time.time() < deadline:
        try:
            if reg.get("m").version == 1:
                break
        except KeyError:
            pass
        time.sleep(0.05)
    snap = reg.get("m")
    svc = DRService(registry=reg)
    y = svc.transform("m", torch.ones((3, 16)))
    assert torch.isfinite(y).all()
    print("FOLLOWER_OK", hid, snap.version, state_hash(snap.state), flush=True)
    sys.stdin.read()      # stay in the fleet until the leader has read its status
else:
    import subprocess
    t0 = TCPTransport("h0")
    reg = ReplicatedRegistry(t0, role="leader")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "follower", f"h{i}", t0.address[0], str(t0.address[1])],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in (1, 2)]
    deadline = time.time() + 120.0
    while len(t0.peers()) < 2 and time.time() < deadline:
        time.sleep(0.05)
    assert len(t0.peers()) == 2, t0.peers()
    m = model()
    s0 = m.init(torch.Generator().manual_seed(0))
    reg.register("m", m, s0)
    s1 = m.update(s0, torch.ones((4, 16)))
    v = reg.push("m", s1)
    assert reg.promote("m", v) == 1
    fs = reg.fleet_status()
    assert len(fs) == 3 and all(s["live"]["m"] == 1 for s in fs.values()), fs
    want_hash = state_hash(reg.get("m").state)
    for p in procs:
        out, err = p.communicate(input="", timeout=120)
        assert p.returncode == 0, err[-2000:]
        line = [l for l in out.splitlines() if l.startswith("FOLLOWER_OK")][0]
        _, hid, version, shash = line.split()
        assert version == "1" and shash == want_hash, line
    print("REPLICATION_TCP_OK")
'''


@pytest.mark.slow
def test_tcp_fleet_multiprocess(tmp_path):
    """Three real processes, real sockets, every model on the CPU: followers
    join a TCP leader, anti-entropy syncs them, and a two-phase promote
    flips the whole fleet to one content-identical live state."""
    script = tmp_path / "tcp_fleet.py"
    script.write_text(TCP_FLEET_SCRIPT)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, str(script), "leader"],
                         capture_output=True, text=True, cwd=repo_root, timeout=300,
                         env={"PYTHONPATH": os.path.join(repo_root, "src"),
                              "PATH": os.environ.get("PATH", "/usr/bin:/bin")})
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    assert "REPLICATION_TCP_OK" in out.stdout


def test_serve_exports_the_references_names():
    """`repro_torch.serve` exports what `repro.serve` does, the mesh
    adapters (`dr_serve`, `dr_transform`, `make_dr_transform`) included."""
    import repro.serve as jserve
    import repro_torch.serve as tserve

    assert set(jserve.__all__) == set(tserve.__all__)
    for name in tserve.__all__:
        assert hasattr(tserve, name), name
