"""repro_torch.serve — online serving for DR models and the LM steps, on one
card.

The engine (`repro_torch.serve.engine.DRService`) is the front door: model
registry + dynamic micro-batching + train-while-serve + per-bucket SLO
accounting, each bucket program a CUDA graph captured at register time.
`repro_torch.serve.scheduler.DeadlineScheduler` wraps the engine's
admission queue in a deadline-driven event loop (flush on fill OR oldest
deadline, all time through the injectable `repro_torch.serve.clock.Clock`).

  batching    — `BucketPolicy`, `BoundedCompileCache`, `MicroBatcher`, `Ticket`
  clock       — `Clock`, `MonotonicClock`, `VirtualClock`
  slo         — `LatencyStats`, `BucketSLO`, `SLOTracker`
  registry    — `ModelRegistry`, `Snapshot`, `model_config_hash`
  durability  — `host_state`, `state_hash` (content addressing)
  engine      — `DRService`, `CapturedProgram`
  scheduler   — `DeadlineScheduler`, `SchedulerClosed`
  serve_step  — `make_prefill` / `make_decode` over `models.api`

The fleet (replication, transport, election, the durable store, fleet
merge) is not ported yet (ROADMAP A8).
"""

from repro_torch.serve import (batching, clock, durability, engine, registry, scheduler,
                               serve_step, slo)
from repro_torch.serve.batching import (BoundedCompileCache, BucketPolicy, MicroBatcher,
                                        QueueFull, Ticket)
from repro_torch.serve.clock import Clock, MonotonicClock, VirtualClock
from repro_torch.serve.durability import state_hash
from repro_torch.serve.engine import DRService
from repro_torch.serve.registry import ModelRegistry
from repro_torch.serve.scheduler import DeadlineScheduler, SchedulerClosed
from repro_torch.serve.slo import LatencyStats, SLOTracker

__all__ = [
    "engine", "registry", "batching", "serve_step", "scheduler", "clock", "slo",
    "durability",
    "DRService", "ModelRegistry", "DeadlineScheduler", "SchedulerClosed",
    "BucketPolicy", "BoundedCompileCache", "MicroBatcher", "QueueFull",
    "Ticket", "Clock", "MonotonicClock", "VirtualClock",
    "LatencyStats", "SLOTracker", "state_hash",
]
