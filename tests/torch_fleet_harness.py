"""The port's twin of `tests/harness.py::FleetHarness`: a replicated serving
fleet of `repro_torch.serve` hosts on one `LocalBus` and one `VirtualClock`.

Each host wraps its `ReplicatedRegistry` in its own `DRService`, so a test
drives real request paths on every replica while mutations go through the
leader.  Deterministic like the reference's: LocalBus delivery is
synchronous in the caller's thread and all serving time is virtual.  The
options are the reference's: `elect=True` (a pumped `Elector` per host),
`durable=True` (a `data_dir` per host under `data_root`, with crash /
torn-tail / restart helpers) and `merge=True` (a `FleetMerger` per host on
one `CompressConfig`).

The standard model is the reference's small RP→EASI cascade (32 → 16 → 8,
block 4) on the CPU with the kernel backend, whose wrappers run their plain
versions for CPU tensors.  States come from the port's own `init` (torch
cannot draw JAX's keys); parity tests import the reference's instead.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, List, Optional

import torch

from repro_torch import dr as tdr
from repro_torch.dist.compress import CompressConfig
from repro_torch.serve import (BucketPolicy, DRService, Elector, FleetMerger, LocalBus,
                               ReplicatedRegistry, VirtualClock)


def small_model(m: int = 32, p: int = 16, n: int = 8, block: int = 4, *,
                backend: str = "kernel", device: str = "cpu") -> tdr.DRModel:
    """The standard tiny RP→EASI cascade the serving tests use."""
    return tdr.DRModel(stages=(tdr.RPStage(m, p), tdr.EASIStage.rotation(p, n, mu=1e-3)),
                       execution=tdr.Execution(backend=backend, device=device),
                       block_size=block)


def init_state(model: tdr.DRModel, seed: int):
    return model.init(torch.Generator().manual_seed(seed))


def model_states(n: int, model: Optional[tdr.DRModel] = None, start: int = 0):
    """`(model, [state0, ..])` — n independently-seeded states of the
    standard small model."""
    model = model if model is not None else small_model()
    return model, [init_state(model, start + i) for i in range(n)]


class FleetHarness:
    """N hosts (`h0` the leader, `h1…` followers) on one bus and clock."""

    def __init__(self, n_hosts: int = 3, *, quorum: Optional[int] = None,
                 elect: bool = False, seed: int = 0,
                 election_timeouts: Optional[List[float]] = None,
                 heartbeat_interval_ms: float = 50.0,
                 buckets: Optional[BucketPolicy] = None,
                 durable: bool = False, data_root: Optional[str] = None,
                 fsync: bool = True, compact_every: int = 256,
                 merge: bool = False,
                 merge_cfg: Optional[CompressConfig] = None,
                 **service_kw: Any):
        if n_hosts < 1:
            raise ValueError("need at least the leader host")
        self.clock = VirtualClock()
        self.bus = LocalBus()
        self.durable = durable
        if durable and data_root is None:
            data_root = tempfile.mkdtemp(prefix="fleet-durable-")
        self.data_root = str(data_root) if data_root is not None else None
        self._fsync = fsync
        self._compact_every = compact_every
        self._quorum = quorum
        self._elect = elect
        self._seed = seed
        self._election_timeouts = election_timeouts
        self._heartbeat_ms = heartbeat_interval_ms
        self.leader = ReplicatedRegistry(self.bus.attach("h0"), role="leader",
                                         quorum=quorum, **self._durable_kw("h0"))
        self.registries: List[ReplicatedRegistry] = [self.leader]
        for i in range(1, n_hosts):
            self.registries.append(ReplicatedRegistry(
                self.bus.attach(f"h{i}"), role="follower", leader="h0",
                quorum=quorum, **self._durable_kw(f"h{i}")))
        self.electors: List[Elector] = []
        if elect:
            for i, reg in enumerate(self.registries):
                self.electors.append(self._make_elector(reg, i))
        kw = dict(service_kw)
        kw.setdefault("buckets", buckets if buckets is not None
                      else BucketPolicy(min_bucket=4, max_bucket=32))
        self._service_kw = kw
        self.services: List[DRService] = [
            DRService(registry=reg, clock=self.clock, **kw) for reg in self.registries]
        self._merge = merge
        self._merge_cfg = merge_cfg if merge_cfg is not None \
            else CompressConfig(ratio=8, min_size=64)
        self.mergers: List[FleetMerger] = []
        if merge:
            self.mergers = [FleetMerger(svc, compress_cfg=self._merge_cfg)
                            for svc in self.services]

    def _durable_kw(self, host_id: str) -> Dict[str, Any]:
        if not self.durable:
            return {}
        return {"data_dir": os.path.join(self.data_root, host_id),
                "fsync": self._fsync, "compact_every": self._compact_every}

    def _make_elector(self, reg: ReplicatedRegistry, index: int) -> Elector:
        if self._election_timeouts is not None:
            t = float(self._election_timeouts[index])
            rng_range = (t, t)
        else:
            rng_range = (150.0, 300.0)
        return Elector(reg, clock=self.clock, seed=self._seed * 1009 + index,
                       election_timeout_ms=rng_range,
                       heartbeat_interval_ms=self._heartbeat_ms)

    # ---- fleet operations ---------------------------------------------------
    def register(self, name: str, model: Any, state: Any, **kw: Any) -> int:
        return self.leader.register(name, model, state, **kw)

    def push_promote(self, name: str, state: Any) -> int:
        v = self.leader.push(name, state)
        return self.leader.promote(name, v)

    def join_host(self, host_id: str, **service_kw: Any) -> DRService:
        """Attach a late host: it syncs from the leader on construction."""
        reg = ReplicatedRegistry(self.bus.attach(host_id), role="follower",
                                 leader="h0", **self._durable_kw(host_id))
        kw = dict(service_kw)
        kw.setdefault("buckets", self.services[0].buckets)
        svc = DRService(registry=reg, clock=self.clock, **kw)
        self.registries.append(reg)
        self.services.append(svc)
        if self._merge:
            self.mergers.append(FleetMerger(svc, compress_cfg=self._merge_cfg))
        return svc

    # ---- crash / restart (durable=True) --------------------------------------
    def crash_host(self, host_id: str) -> str:
        """`kill -9`: detach the host and drop its objects without closing
        anything — only what reached the disk survives."""
        idx = self.host_ids().index(host_id)
        self.bus.detach(host_id)
        self.registries.pop(idx)
        self.services.pop(idx)
        self.electors = [e for e in self.electors if e.host_id != host_id]
        self.mergers = [m for m in self.mergers if m.host_id != host_id]
        return host_id

    def restart_host(self, host_id: str, *, role: str = "follower",
                     leader: Optional[str] = None) -> DRService:
        """Rebuild a crashed host from its data_dir, then `join()` the fleet."""
        assert self.durable, "restart_host requires FleetHarness(durable=True)"
        if role == "follower" and leader is None:
            live = [r for r in self.reachable() if r.role == "leader"]
            leader = live[0].transport.host_id if live else "h0"
        reg = ReplicatedRegistry(self.bus.attach(host_id), role=role,
                                 leader=leader, quorum=self._quorum,
                                 sync_on_start=False, **self._durable_kw(host_id))
        if role == "leader":
            self.leader = reg
        self.registries.append(reg)
        if self._elect:
            self.electors.append(self._make_elector(reg, int(host_id.lstrip("h") or 0)))
        svc = DRService(registry=reg, clock=self.clock, **self._service_kw)
        self.services.append(svc)
        if self._merge:
            self.mergers.append(FleetMerger(svc, compress_cfg=self._merge_cfg))
        try:
            reg.join()
        except Exception:               # noqa: BLE001 — no reachable leader
            pass                        # yet; anti-entropy heals later
        return svc

    def wal_path(self, host_id: str) -> str:
        assert self.durable and self.data_root is not None
        return os.path.join(self.data_root, host_id, "wal.log")

    def inject_torn_tail(self, host_id: str,
                         garbage: bytes = b"\x00\x00\x01\x99TORN-REC") -> None:
        with open(self.wal_path(host_id), "ab") as f:
            f.write(garbage)

    # ---- election driving (elect=True) ---------------------------------------
    def host_ids(self) -> List[str]:
        return [r.transport.host_id for r in self.registries]

    def registry_for(self, host_id: str) -> ReplicatedRegistry:
        return self.registries[self.host_ids().index(host_id)]

    def service_for(self, host_id: str) -> DRService:
        return self.services[self.host_ids().index(host_id)]

    def reachable(self) -> List[ReplicatedRegistry]:
        cut = set(self.bus.partitioned())
        return [r for r in self.registries if r.transport.host_id not in cut]

    def current_leader(self) -> Optional[ReplicatedRegistry]:
        leaders = [r for r in self.reachable() if r.role == "leader"]
        return leaders[0] if len(leaders) == 1 else None

    def kill_leader(self) -> str:
        leaders = [r for r in self.reachable() if r.role == "leader"]
        assert leaders, "no reachable leader to kill"
        dead = leaders[0].transport.host_id
        self.bus.partition(dead)
        return dead

    def heal(self, *host_ids: str) -> None:
        self.bus.heal(*host_ids)

    def pump_elections(self, max_ms: float = 60_000.0) -> str:
        """Advance the shared clock to the earliest reachable elector
        deadline and poll every reachable elector, until one agreed leader
        exists; returns its id."""
        assert self.electors, "FleetHarness(elect=True) required"
        spent = 0.0
        while True:
            winner = self._agreed_leader()
            if winner is not None:
                return winner
            if spent >= max_ms:
                raise AssertionError(
                    f"no agreed leader within {max_ms} virtual ms: "
                    f"{[e.status() for e in self.electors]}")
            cut = set(self.bus.partitioned())
            live = [e for e in self.electors if e.host_id not in cut]
            step = max(0.0, min(e.deadline_ms() for e in live) - self.clock.now()) + 0.001
            self.clock.advance(step)
            spent += step
            for e in live:
                e.poll()

    def _agreed_leader(self) -> Optional[str]:
        regs = self.reachable()
        leaders = [r for r in regs if r.role == "leader"]
        if len(leaders) != 1:
            return None
        lead = leaders[0]
        lid, lterm = lead.transport.host_id, lead.term
        if all(r.leader == lid and r.term == lterm for r in regs):
            return lid
        return None

    # ---- fleet merge driving (merge=True) ------------------------------------
    def merger_for(self, host_id: str) -> FleetMerger:
        for m in self.mergers:
            if m.host_id == host_id:
                return m
        raise KeyError(f"no merger for {host_id!r}")

    def pump_merge(self, name: str) -> Dict[str, Any]:
        """One leader-coordinated merge round on whoever leads."""
        assert self.mergers, "FleetHarness(merge=True) required"
        lead = self.current_leader() if self._elect else self.leader
        assert lead is not None, "no agreed leader to drive the merge"
        return self.merger_for(lead.transport.host_id).merge_round(name)

    # ---- observation ----------------------------------------------------------
    def live_versions(self, name: str) -> List[Optional[int]]:
        out: List[Optional[int]] = []
        for reg in self.registries:
            try:
                out.append(reg.get(name).version)
            except KeyError:
                out.append(None)
        return out

    def converged(self, name: str) -> bool:
        vs = self.live_versions(name)
        return None not in vs and len(set(vs)) == 1

    def statuses(self) -> Dict[str, Dict[str, Any]]:
        return {r.transport.host_id: r.status() for r in self.registries}
