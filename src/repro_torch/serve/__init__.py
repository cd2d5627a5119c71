"""repro_torch.serve — online serving for DR models and the LM steps.

The engine (`repro_torch.serve.engine.DRService`) is the front door: model
registry + dynamic micro-batching + train-while-serve + per-bucket SLO
accounting, each bucket program a CUDA graph captured at register time.
`repro_torch.serve.scheduler.DeadlineScheduler` wraps the engine's
admission queue in a deadline-driven event loop (flush on fill OR oldest
deadline, all time through the injectable `repro_torch.serve.clock.Clock`).
`repro_torch.serve.replication.ReplicatedRegistry` replicates a fleet of
registries (op log + two-phase atomic promote) over a
`repro_torch.serve.transport.Transport` (`LocalBus` in tests,
`TCPTransport` for multi-process fleets) and plugs into the engine via
`DRService(registry=...)`; `repro_torch.serve.election.Elector` re-elects a
leader when one dies; `repro_torch.serve.fleet_merge.FleetMerger` merges
the hosts' train-while-serve deltas through the paper's RP sketch.
`repro_torch.serve.durability` makes each host crash-safe (checksummed WAL
+ content-addressed blobs + compacted snapshots;
`ReplicatedRegistry(data_dir=...)` or the single-host
`DRService(data_dir=...)` hook).

  batching    — `BucketPolicy`, `BoundedCompileCache`, `MicroBatcher`, `Ticket`
  clock       — `Clock`, `MonotonicClock`, `VirtualClock`
  slo         — `LatencyStats`, `BucketSLO`, `SLOTracker`
  registry    — `ModelRegistry`, `Snapshot`, `model_config_hash`
  durability  — `host_state`, `state_hash`, `WriteAheadLog`, `BlobStore`,
                `DurableStore`
  transport   — `Transport`, `LocalBus`, `TCPTransport`
  replication — `ReplicatedRegistry`, `Op`
  election    — `Elector`
  fleet_merge — `FleetMerger`
  engine      — `DRService`, `CapturedProgram`
  scheduler   — `DeadlineScheduler`, `SchedulerClosed`
  serve_step  — `make_prefill` / `make_decode` over `models.api`, with or
                without a mesh
  dr_serve    — `make_dr_transform` / `dr_transform`: DR serving on a mesh
"""

from repro_torch.serve import (batching, clock, dr_serve, durability, election, engine,
                               fleet_merge, registry, replication, scheduler, serve_step, slo,
                               transport)
from repro_torch.serve.batching import (BoundedCompileCache, BucketPolicy, MicroBatcher,
                                        QueueFull, Ticket)
from repro_torch.serve.clock import Clock, MonotonicClock, VirtualClock
from repro_torch.serve.dr_serve import dr_transform, make_dr_transform
from repro_torch.serve.durability import (BlobStore, CorruptBlobError, DurableStore,
                                          WriteAheadLog)
from repro_torch.serve.election import Elector
from repro_torch.serve.engine import DRService
from repro_torch.serve.fleet_merge import FleetMerger, MergeError
from repro_torch.serve.registry import ModelRegistry
from repro_torch.serve.replication import Op, ReplicatedRegistry, ReplicationError, state_hash
from repro_torch.serve.scheduler import DeadlineScheduler, SchedulerClosed
from repro_torch.serve.slo import LatencyStats, SLOTracker
from repro_torch.serve.transport import LocalBus, TCPTransport, Transport, TransportError

__all__ = [
    "engine", "registry", "batching", "serve_step", "dr_serve", "scheduler", "clock", "slo",
    "replication", "transport", "election", "durability", "fleet_merge",
    "Elector", "FleetMerger", "MergeError",
    "DurableStore", "WriteAheadLog", "BlobStore", "CorruptBlobError",
    "DRService", "ModelRegistry", "DeadlineScheduler", "SchedulerClosed",
    "BucketPolicy", "BoundedCompileCache", "MicroBatcher", "QueueFull",
    "Ticket", "Clock", "MonotonicClock", "VirtualClock",
    "LatencyStats", "SLOTracker",
    "ReplicatedRegistry", "ReplicationError", "Op", "state_hash",
    "LocalBus", "TCPTransport", "Transport", "TransportError",
    "dr_transform", "make_dr_transform",
]
