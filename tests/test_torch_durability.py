"""The port's durable fleet persistence (`repro_torch.serve.durability`),
test for test the twin of `tests/test_durability.py`: WAL torn-tail
recovery (a real `kill -9` mid-append subprocess and a hypothesis sweep over
every truncation offset), content-addressed blob store semantics, snapshot
compaction + GC, the solo durable `DRService(data_dir=...)` restart, and the
fleet scenarios — a quorum-committed promote survives a crash + injected
torn tail, a full-fleet restart restores the registry from disk, and a
restarted host never grants a second vote in a term it already voted in.

Records and blobs hold the port's own classes with CPU-tensor leaves; the
port does not read the JAX package's data directories (their records pickle
that package's classes)."""

import os
import pickle
import signal
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tree_mod
from repro_torch.serve import (DRService, Elector, LocalBus, ReplicatedRegistry,
                               VirtualClock)
from repro_torch.serve.durability import (_FRAME, BlobStore, CorruptBlobError, DurableStore,
                                          WriteAheadLog, host_state, state_hash)
from repro_torch.serve.replication import Op

from torch_fleet_harness import FleetHarness, model_states as _states

pytestmark = pytest.mark.durability


def _x(rows, seed=0, m=32):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((rows, m)).astype(np.float32))


def _frame_len(record) -> int:
    return _FRAME.size + len(pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL))


# ---------------------------------------------------------------------------
# write-ahead log
# ---------------------------------------------------------------------------

class TestWAL:
    def test_round_trip(self, tmp_path):
        p = str(tmp_path / "wal.log")
        wal = WriteAheadLog(p)
        recs = [("op", i, "x" * i) for i in range(10)]
        for r in recs:
            wal.append(r)
        wal.close()
        wal2 = WriteAheadLog(p)
        assert wal2.records == recs
        wal2.close()

    def test_empty_and_missing(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path / "fresh.log"))
        assert wal.records == []
        wal.append(("a", 1))
        wal.close()

    def test_torn_partial_header(self, tmp_path):
        p = str(tmp_path / "wal.log")
        wal = WriteAheadLog(p)
        for i in range(5):
            wal.append(("rec", i))
        wal.close()
        good = os.path.getsize(p)
        with open(p, "ab") as f:
            f.write(b"\x00\x00")
        wal2 = WriteAheadLog(p)
        assert wal2.records == [("rec", i) for i in range(5)]
        assert os.path.getsize(p) == good
        wal2.close()

    def test_torn_partial_payload(self, tmp_path):
        p = str(tmp_path / "wal.log")
        wal = WriteAheadLog(p)
        wal.append(("rec", 0))
        wal.close()
        good = os.path.getsize(p)
        payload = pickle.dumps(("rec", 1), protocol=pickle.HIGHEST_PROTOCOL)
        frame = _FRAME.pack(len(payload), zlib.crc32(payload)) + payload
        with open(p, "ab") as f:
            f.write(frame[: len(frame) // 2])
        wal2 = WriteAheadLog(p)
        assert wal2.records == [("rec", 0)]
        assert os.path.getsize(p) == good
        wal2.close()

    def test_impossible_length_header(self, tmp_path):
        p = str(tmp_path / "wal.log")
        wal = WriteAheadLog(p)
        wal.append(("rec", 0))
        wal.close()
        with open(p, "ab") as f:
            f.write(_FRAME.pack(1 << 31, 0))
        wal2 = WriteAheadLog(p)
        assert wal2.records == [("rec", 0)]
        wal2.close()

    def test_mid_file_byte_flip_truncates_to_prefix(self, tmp_path):
        p = str(tmp_path / "wal.log")
        wal = WriteAheadLog(p)
        recs = [("rec", i, os.urandom(20)) for i in range(8)]
        for r in recs:
            wal.append(r)
        wal.close()
        off = sum(_frame_len(r) for r in recs[:3]) + _FRAME.size + 2
        with open(p, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
        wal2 = WriteAheadLog(p)
        assert wal2.records == recs[:3]
        wal2.close()

    def test_append_after_recovery_round_trips(self, tmp_path):
        p = str(tmp_path / "wal.log")
        wal = WriteAheadLog(p)
        wal.append(("rec", 0))
        wal.close()
        with open(p, "ab") as f:
            f.write(b"TORN")
        wal2 = WriteAheadLog(p)
        wal2.append(("rec", 1))
        wal2.close()
        wal3 = WriteAheadLog(p)
        assert wal3.records == [("rec", 0), ("rec", 1)]
        wal3.close()

    def test_truncate_resets(self, tmp_path):
        p = str(tmp_path / "wal.log")
        wal = WriteAheadLog(p)
        for i in range(4):
            wal.append(i)
        wal.truncate()
        assert wal.records == []
        assert os.path.getsize(p) == 0
        wal.append("after")
        wal.close()
        wal2 = WriteAheadLog(p)
        assert wal2.records == ["after"]
        wal2.close()

    def test_tensor_records_round_trip(self, tmp_path):
        """The port's records: a carry tree of CPU tensors comes back with the
        same bytes (the reference's carries are numpy)."""
        p = str(tmp_path / "wal.log")
        _, (s0,) = _states(1)
        wal = WriteAheadLog(p)
        wal.append(("residual", ("m", host_state(s0))))
        wal.close()
        kind, (name, got) = WriteAheadLog(p).records[0]
        assert (kind, name) == ("residual", "m") and state_hash(got) == state_hash(s0)
        assert all(t.device.type == "cpu" for t in tree_mod.leaves(got))


class TestWALKillNine:
    def test_sigkill_mid_append_leaves_contiguous_prefix(self, tmp_path):
        p = str(tmp_path / "wal.log")
        src = os.path.join(os.path.dirname(__file__), "..", "src")
        child = (
            "import sys; sys.path.insert(0, sys.argv[2])\n"
            "from repro_torch.serve.durability import WriteAheadLog\n"
            "wal = WriteAheadLog(sys.argv[1], fsync=False)\n"
            "print('READY', flush=True)\n"
            "i = 0\n"
            "while True:\n"
            "    wal.append(('rec', i, 'x' * 64))\n"
            "    i += 1\n")
        proc = subprocess.Popen([sys.executable, "-c", child, p, src],
                                stdout=subprocess.PIPE, env=dict(os.environ))
        try:
            assert proc.stdout.readline().strip() == b"READY"
            deadline = time.time() + 30.0
            while time.time() < deadline:
                if os.path.exists(p) and os.path.getsize(p) > 4096:
                    break
                time.sleep(0.01)
            assert os.path.getsize(p) > 0, "child never wrote a record"
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
        wal = WriteAheadLog(p)
        assert len(wal.records) > 0
        for i, rec in enumerate(wal.records):
            assert rec == ("rec", i, "x" * 64)
        wal.append(("rec", len(wal.records), "x" * 64))
        wal.close()


class TestWALProperty:
    def test_truncation_at_any_offset_yields_exact_prefix(self):
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st

        @settings(max_examples=60, deadline=None)
        @given(payloads=st.lists(st.binary(min_size=0, max_size=48), min_size=0, max_size=10),
               data=st.data())
        def prop(payloads, data):
            with tempfile.TemporaryDirectory() as d:
                p = os.path.join(d, "wal.log")
                wal = WriteAheadLog(p, fsync=False)
                for b in payloads:
                    wal.append(b)
                wal.close()
                size = os.path.getsize(p)
                cut = data.draw(st.integers(min_value=0, max_value=size), label="cut offset")
                with open(p, "r+b") as f:
                    f.truncate(cut)
                ends, total = [], 0
                for b in payloads:
                    total += _frame_len(b)
                    ends.append(total)
                expect = [b for b, e in zip(payloads, ends) if e <= cut]
                wal2 = WriteAheadLog(p, fsync=False)
                assert wal2.records == expect
                wal2.append(b"post-recovery-1")
                wal2.append(b"post-recovery-2")
                wal2.close()
                wal3 = WriteAheadLog(p, fsync=False)
                assert wal3.records == expect + [b"post-recovery-1", b"post-recovery-2"]
                wal3.close()

        prop()


# ---------------------------------------------------------------------------
# blob store
# ---------------------------------------------------------------------------

class TestBlobStore:
    def test_put_get_round_trip_and_dedupe(self, tmp_path):
        store = BlobStore(str(tmp_path / "blobs"))
        _, (s0,) = _states(1)
        h = state_hash(s0)
        assert store.put(h, s0) is True
        assert store.put(h, s0) is False
        assert h in store
        got = store.get(h)
        assert state_hash(got) == h
        for a, b in zip(tree_mod.leaves(got), tree_mod.leaves(s0)):
            assert torch.equal(a, b)

    def test_get_missing_raises_keyerror(self, tmp_path):
        store = BlobStore(str(tmp_path / "blobs"))
        with pytest.raises(KeyError):
            store.get("deadbeef00000000")

    def test_verify_on_get_detects_silent_corruption(self, tmp_path):
        store = BlobStore(str(tmp_path / "blobs"))
        _, (s0, s1) = _states(2)
        h = state_hash(s0)
        store.put(h, s0)
        with open(store._path(h), "wb") as f:
            pickle.dump(host_state(s1), f, protocol=pickle.HIGHEST_PROTOCOL)
        with pytest.raises(CorruptBlobError):
            store.get(h)
        store.get(h, verify=False)

    def test_get_unreadable_blob_raises(self, tmp_path):
        store = BlobStore(str(tmp_path / "blobs"))
        _, (s0,) = _states(1)
        h = state_hash(s0)
        store.put(h, s0)
        blob = bytearray(open(store._path(h), "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        with open(store._path(h), "wb") as f:
            f.write(bytes(blob))
        with pytest.raises(CorruptBlobError):
            store.get(h)

    def test_gc_removes_only_unreferenced(self, tmp_path):
        store = BlobStore(str(tmp_path / "blobs"))
        _, (s0, s1, s2) = _states(3)
        hs = [state_hash(s) for s in (s0, s1, s2)]
        for h, s in zip(hs, (s0, s1, s2)):
            store.put(h, s)
        removed = store.gc(live={hs[0], hs[2]})
        assert removed == 1
        assert set(store.hashes()) == {hs[0], hs[2]}


# ---------------------------------------------------------------------------
# durable store: snapshots + compaction + fold
# ---------------------------------------------------------------------------

def _op(seq, kind="push", name="m", version=None, h=None, term=0):
    return Op(seq=seq, kind=kind, name=name, version=version, state_hash=h, term=term)


class TestDurableStore:
    def test_recover_empty(self, tmp_path):
        store = DurableStore(str(tmp_path / "d"))
        rec = store.recover()
        assert rec.ops == {} and rec.term == 0 and rec.voted == {}
        store.close()

    def test_wal_fold_ops_term_votes(self, tmp_path):
        d = str(tmp_path / "d")
        store = DurableStore(d)
        ops = [_op(0, "register"), _op(1), _op(2, "promote", version=1)]
        for op in ops:
            store.log_op(op)
        store.log_term(3)
        store.log_vote(4, "hB")
        store.close()
        store2 = DurableStore(d)
        rec = store2.recover()
        assert rec.ops == {"m": ops}
        assert rec.term == 4
        assert rec.voted == {4: "hB"}
        store2.close()

    def test_fold_is_idempotent_by_seq(self, tmp_path):
        d = str(tmp_path / "d")
        store = DurableStore(d)
        ops = [_op(0, "register"), _op(1)]
        for op in ops:
            store.log_op(op)
        store.compact({"ops": {"m": ops}, "term": 0, "voted": {}})
        for op in ops:
            store.log_op(op)
        store.close()
        rec = DurableStore(d).recover()
        assert rec.ops == {"m": ops}

    def test_seq_gap_drops_name_suffix(self, tmp_path):
        d = str(tmp_path / "d")
        store = DurableStore(d)
        store.log_op(_op(0, "register"))
        store.log_op(_op(3))
        store.log_op(_op(4))
        store.close()
        rec = DurableStore(d).recover()
        assert [o.seq for o in rec.ops["m"]] == [0]

    def test_reset_record_drops_name(self, tmp_path):
        d = str(tmp_path / "d")
        store = DurableStore(d)
        store.log_op(_op(0, "register"))
        store.log_reset("m")
        store.close()
        rec = DurableStore(d).recover()
        assert "m" not in rec.ops

    def test_compact_truncates_wal_and_gcs_blobs(self, tmp_path):
        d = str(tmp_path / "d")
        store = DurableStore(d, compact_every=4)
        _, (s0, s1) = _states(2)
        h0, h1 = state_hash(s0), state_hash(s1)
        store.blobs.put(h0, s0)
        store.blobs.put(h1, s1)
        ops = [_op(0, "register", h=h0)]
        store.log_op(ops[0])
        store.compact({"ops": {"m": ops}, "term": 2, "voted": {2: "hA"}})
        assert store.wal.size_bytes() == 0
        assert set(store.blobs.hashes()) == {h0}
        assert store.stats()["compactions"] == 1
        store.close()
        rec = DurableStore(d).recover()
        assert rec.ops == {"m": ops}
        assert rec.term == 2 and rec.voted == {2: "hA"}

    def test_corrupt_snapshot_quarantined_falls_back(self, tmp_path):
        d = str(tmp_path / "d")
        store = DurableStore(d)
        ops_a = [_op(0, "register")]
        store.compact({"ops": {"m": ops_a}, "term": 1, "voted": {}})
        ops_b = ops_a + [_op(1)]
        store.compact({"ops": {"m": ops_b}, "term": 2, "voted": {}})
        sid = store._snap_ids()[-1]
        path = os.path.join(store._snap_path(sid), "state.pkl")
        with open(path, "r+b") as f:
            f.seek(4)
            f.write(b"\xde\xad")
        store.close()
        store2 = DurableStore(d)
        rec = store2.recover()
        assert rec.ops == {"m": ops_a} and rec.term == 1
        assert any(n.endswith(".corrupt") for n in os.listdir(store2.snap_dir))
        store2.close()

    def test_auto_compaction_counter(self, tmp_path):
        store = DurableStore(str(tmp_path / "d"), compact_every=3)
        assert not store.should_compact()
        for i in range(3):
            store.log_op(_op(i, "register" if i == 0 else "push"))
        assert store.should_compact()
        store.compact({"ops": {}, "term": 0, "voted": {}})
        assert not store.should_compact()
        store.close()


# ---------------------------------------------------------------------------
# solo durable service
# ---------------------------------------------------------------------------

class TestSoloServiceRestart:
    def test_restart_restores_registry_bit_identical(self, tmp_path):
        d = str(tmp_path / "solo")
        model, (s0, s1) = _states(2)
        svc = DRService(data_dir=d)
        svc.register("m", model, s0)
        svc.registry.push("m", s1)
        svc.promote("m", 1)
        x = _x(8)
        want = svc.transform("m", x)
        live_hash = state_hash(svc.registry.get("m").state)
        del svc

        svc2 = DRService(data_dir=d)
        snap = svc2.registry.get("m")
        assert snap.version == 1
        assert state_hash(snap.state) == live_hash
        assert torch.equal(svc2.transform("m", x), want)

    def test_restart_after_compaction(self, tmp_path):
        d = str(tmp_path / "solo")
        model, states = _states(4)
        svc = DRService(data_dir=d)
        svc.register("m", model, states[0])
        for s in states[1:]:
            svc.registry.push("m", s)
        svc.promote("m", 3)
        svc.registry.compact()
        assert svc.registry.durability_stats()["wal_bytes"] == 0
        del svc

        svc2 = DRService(data_dir=d)
        assert svc2.registry.get("m").version == 3
        assert state_hash(svc2.registry.get("m").state) == state_hash(states[3])

    def test_data_dir_and_registry_together_is_refused(self, tmp_path):
        with pytest.raises(ValueError, match="data_dir OR registry"):
            DRService(data_dir=str(tmp_path / "solo"),
                      registry=ReplicatedRegistry(LocalBus().attach("x"), role="leader"))

    def test_solo_service_train_while_serve_survives_restart(self, tmp_path):
        """serve_and_update + promote on a durable solo service: the promoted
        fold is what a restart serves, on the model's device."""
        d = str(tmp_path / "solo")
        model, (s0,) = _states(1)
        svc = DRService(data_dir=d)
        svc.register("m", model, s0)
        blocks = _x(16, seed=4).reshape(4, 4, 32)
        for blk in blocks:
            svc.serve_and_update("m", blk)
        v = svc.promote("m")
        want = state_hash(svc.registry.get("m").state)
        del svc
        svc2 = DRService(data_dir=d)
        snap = svc2.registry.get("m")
        assert snap.version == v and state_hash(snap.state) == want
        assert int(snap.state.steps) == 4
        assert all(t.device.type == "cpu" for t in snap.state.stages)


# ---------------------------------------------------------------------------
# fleet chaos: crash, torn tail, restart-into-live-fleet
# ---------------------------------------------------------------------------

class TestFleetCrashRecovery:
    def test_committed_promote_survives_crash_and_torn_tail(self, tmp_path):
        fleet = FleetHarness(n_hosts=3, durable=True, data_root=str(tmp_path), compact_every=4)
        model, (s0, s1, s2) = _states(3)
        fleet.register("m", model, s0)
        v1 = fleet.push_promote("m", s1)
        assert fleet.live_versions("m") == [v1] * 3

        fleet.crash_host("h1")
        fleet.inject_torn_tail("h1")
        v2 = fleet.push_promote("m", s2)

        fleet.restart_host("h1")
        assert fleet.converged("m")
        assert set(fleet.live_versions("m")) == {v2}
        assert state_hash(fleet.registry_for("h1").get("m").state) == \
            state_hash(fleet.leader.get("m").state)

    def test_torn_tail_never_loses_committed_prefix(self, tmp_path):
        fleet = FleetHarness(n_hosts=3, durable=True, data_root=str(tmp_path))
        model, (s0, s1) = _states(2)
        fleet.register("m", model, s0)
        v1 = fleet.push_promote("m", s1)
        fleet.crash_host("h2")
        fleet.inject_torn_tail("h2")
        fleet.restart_host("h2")
        assert fleet.live_versions("m") == [v1] * 3
        assert state_hash(fleet.registry_for("h2").get("m").state) == \
            state_hash(fleet.leader.get("m").state)

    def test_full_fleet_restart_from_disk(self, tmp_path):
        root = str(tmp_path)
        fleet = FleetHarness(n_hosts=3, durable=True, data_root=root, compact_every=4)
        model, (s0, s1, s2) = _states(3)
        fleet.register("m", model, s0)
        fleet.push_promote("m", s1)
        v2 = fleet.push_promote("m", s2)
        want = state_hash(fleet.leader.get("m").state)
        del fleet

        fleet2 = FleetHarness(n_hosts=3, durable=True, data_root=root)
        assert fleet2.live_versions("m") == [v2] * 3
        for reg in fleet2.registries:
            assert state_hash(reg.get("m").state) == want

    def test_restart_triggers_auto_compaction_eventually(self, tmp_path):
        fleet = FleetHarness(n_hosts=2, durable=True, data_root=str(tmp_path), compact_every=3)
        model, states = _states(5)
        fleet.register("m", model, states[0])
        for s in states[1:]:
            fleet.push_promote("m", s)
        stats = fleet.leader.durability_stats()
        assert stats["compactions"] >= 1
        assert stats["snapshots"]
        want = state_hash(fleet.leader.get("m").state)
        fleet.crash_host("h1")
        fleet.restart_host("h1")
        assert fleet.converged("m")
        assert state_hash(fleet.registry_for("h1").get("m").state) == want


# ---------------------------------------------------------------------------
# durable election metadata
# ---------------------------------------------------------------------------

class TestVoteDurability:
    def _voter(self, bus, data_dir, clock):
        reg = ReplicatedRegistry(bus.attach("h0"), role="follower", leader="hA",
                                 sync_on_start=False, data_dir=data_dir)
        elector = Elector(reg, clock=clock, seed=7, election_timeout_ms=(150.0, 150.0))
        return reg, elector

    def test_restart_never_regrants_a_persisted_term(self, tmp_path):
        d = str(tmp_path / "h0")
        clock = VirtualClock()
        bus = LocalBus()
        reg, elector = self._voter(bus, d, clock)
        cand = bus.attach("probe")
        r = cand.send("h0", {"req": "vote", "term": 5, "from": "hA", "log": {}})
        assert r["granted"]
        bus.detach("h0")
        del reg, elector

        reg2, elector2 = self._voter(bus, d, clock)
        assert reg2.recovered_votes() == {5: "hA"}
        assert reg2.term == 5
        r = cand.send("h0", {"req": "vote", "term": 5, "from": "hB", "log": {}})
        assert not r["granted"]
        r = cand.send("h0", {"req": "vote", "term": 5, "from": "hA", "log": {}})
        assert r["granted"]

    def test_restart_refuses_stale_term_votes(self, tmp_path):
        d = str(tmp_path / "h0")
        clock = VirtualClock()
        bus = LocalBus()
        reg, elector = self._voter(bus, d, clock)
        cand = bus.attach("probe")
        assert cand.send("h0", {"req": "vote", "term": 7, "from": "hA", "log": {}})["granted"]
        bus.detach("h0")
        del reg, elector

        reg2, _ = self._voter(bus, d, clock)
        r = cand.send("h0", {"req": "vote", "term": 3, "from": "hB", "log": {}})
        assert not r["granted"] and r["term"] == 7

    def test_candidate_self_vote_survives_restart(self, tmp_path):
        d = str(tmp_path / "h0")
        clock = VirtualClock()
        bus = LocalBus()
        reg, elector = self._voter(bus, d, clock)
        clock.advance(200.0)
        elector.poll()
        assert reg.recovered_votes().get(1) == "h0"
        bus.detach("h0")
        del reg, elector

        reg2, _ = self._voter(bus, d, clock)
        cand = bus.attach("probe")
        r = cand.send("h0", {"req": "vote", "term": 1, "from": "hB", "log": {}})
        assert not r["granted"]
