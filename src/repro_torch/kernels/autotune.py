"""Tile autotuner for the serving engine's bucket programs.

The contract of the JAX package's `kernels/autotune.py`: `DRService` calls
`tune` once per (bucket, device) at registry-register time and stores the
returned `TunedProgram` (built program + winning tiles + every candidate's
time) in its `BoundedCompileCache`, so a promote (same config hash → same
cache key) never re-tunes and an eviction drops the program and its tiles
together.

  * The points are B1's and B3's tile templates (`resource_model.TILE_ROWS`
    x `TILE_P`: 32 or 64 rows of x, at most 16, 32 or 64 rows of R a CTA),
    each one that `resource_model.validate()` admits; the contraction runs
    a 32-column word at a time.  Candidates are DEDUPED by their *effective*
    tiles (`resource_model.effective_tiles`), what the kernels run after the
    clamp: a problem whose R takes the dense body (the paper's 32 × 24) has
    one tiling, so its sweep is one program and tuning is free.
  * On the card a candidate's time is device time: CUDA events around
    REPLAYS calls of its captured program, queued behind a spin kernel so
    that the card runs them back to back, and ended by a wait on the last
    event, so neither host jitter nor an unfinished launch enters it.  The
    kernels take 0.01-0.02 ms at the serving buckets, under the host's
    time to queue one call and under its clock's jitter.  Off the card a call is timed on the
    injected ms timer (the service's `Clock`), never `time.*` directly.
  * The service's clock decides whether time passes: a sample it saw take
    no time (a `VirtualClock`) counts as zero, so every candidate ties.
  * A candidate displaces the leader (at first the model's own `Execution`
    tiles) only where its slowest sample beats the leader's fastest by
    more than RACE_MARGIN.  Ties and near-ties keep the leader, so two
    replicas of one model on like cards choose alike unless a template is
    clearly faster, and a virtual clock keeps the first.
  * Candidate programs are built directly (not through the compile cache),
    so loser programs are dropped on return and cache compile counters keep
    meaning "programs the service retained".
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import resource_model

# Sweep universes: the sparse bodies' tile templates
BLOCK_M_CANDIDATES = resource_model.TILE_ROWS
BLOCK_P_CANDIDATES = resource_model.TILE_P
# a challenger must be this much faster than the leader, beyond the spread
# of both one's samples, to displace it
RACE_MARGIN = 0.10
# calls a sample times on the card
REPLAYS = 16
# the spin that queues a sample's calls ahead of the card: 2^21 cycles, about
# 1 ms at the H100's clocks, doubled while the host needs longer
HOLD_CYCLES = 1 << 21
HOLD_CYCLES_MAX = 1 << 27


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One point of the sweep: the `Execution.tmm_block_*` fields.  The
    kernels read block_m and block_p; block_k mirrors the reference's
    policy field, and an effective point's is the kernels' fixed
    contraction step (WORD)."""

    block_m: int = 128
    block_p: int = 128
    block_k: int = 512

    def effective(self, rows: int, p: int, m: int) -> "TileConfig":
        """The tiles the kernels run for a (rows, p, m) problem, after the
        clamp to the templates and the padded problem (the clamp in the
        kernel wrappers)."""
        bm, bp = resource_model.effective_tiles(rows, p, m, self.block_m, self.block_p)
        return TileConfig(bm, bp, resource_model.WORD)


def candidates(rows: int, p: int, m: int, *,
               first: Optional[TileConfig] = None,
               block_m: Sequence[int] = BLOCK_M_CANDIDATES,
               block_p: Sequence[int] = BLOCK_P_CANDIDATES,
               ) -> Tuple[TileConfig, ...]:
    """The deduped sweep for a (rows, p, m) problem.  `first` (typically
    the model's own Execution tiles) is tried before the universe, so a
    hand-tiled policy survives a tie and a collapsed sweep returns it."""
    seen, out = set(), []
    pool = ([] if first is None else [first]) + [
        TileConfig(bm, bp, resource_model.WORD) for bm in block_m for bp in block_p]
    for cand in pool:
        eff = cand.effective(rows, p, m)
        if eff in seen:
            continue
        seen.add(eff)
        out.append(cand)
    return tuple(out)


def device_key(device: torch.device) -> str:
    """Identity of the device programs are tuned FOR (part of what a cached
    winner is valid against)."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


@dataclasses.dataclass
class TunedProgram:
    """A built program plus the tile choice that won its sweep — cached as
    ONE value, so the winner can never outlive (or be re-derived apart
    from) the program it was tuned for."""

    fn: Callable[..., Any]
    tiles: TileConfig
    device: str
    timings_ms: Dict[TileConfig, float]

    def __call__(self, *args: Any, **kw: Any) -> Any:
        return self.fn(*args, **kw)


def _finish(device: torch.device) -> None:
    """Wait until the card has run everything queued on the current stream
    (a no-op off the card)."""
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()


def _sample(fn: Callable[..., Any], args: Tuple[Any, ...], device: torch.device,
            timer: Callable[[], float], hold: int) -> Tuple[float, bool]:
    """One sample of a candidate's ms a call, and whether it is the card's
    own time.  Off the card: one call on `timer`.  On the card: REPLAYS
    calls between two CUDA events, queued behind a spin of `hold` cycles
    that keeps the card busy while the host queues them, so the events see
    the card's time and not the host's; not the card's own where the host
    took longer to queue them than the spin lasted (the card waited on
    it).  Zero where `timer` did not move (a virtual clock)."""
    if device.type != "cuda":
        t0 = timer()
        fn(*args)
        return timer() - t0, True
    stream = torch.cuda.current_stream(device)
    spun, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    spun.record(stream)
    torch.cuda._sleep(hold)
    start.record(stream)
    t0 = timer()
    for _ in range(REPLAYS):
        fn(*args)
    queued = timer() - t0
    end.record(stream)
    end.synchronize()
    if queued == 0:
        return 0.0, True
    return start.elapsed_time(end) / REPLAYS, queued < spun.elapsed_time(start)


def _beats(challenger: Sequence[float], leader: Sequence[float]) -> bool:
    """Whether the challenger's slowest sample is faster than the leader's
    fastest by more than RACE_MARGIN of it."""
    return max(challenger) < min(leader) * (1.0 - RACE_MARGIN)


def tune(cands: Sequence[TileConfig],
         build: Callable[[TileConfig], Callable[..., Any]],
         args: Tuple[Any, ...],
         *,
         timer: Optional[Callable[[], float]],
         reps: int = 3) -> TunedProgram:
    """Race `build(tiles)(*args)` across candidates, `reps` samples each
    (`_sample`); a candidate takes the lead only where `_beats` says so,
    so ties and near-ties keep the earliest candidate.  A single-candidate
    sweep skips timing entirely, and needs no timer; `args` (a
    bucket-shaped dummy call) name the device the program is tuned for.
    `timings_ms` holds each candidate's fastest sample."""
    if not cands:
        raise ValueError("tune needs at least one candidate")
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    if len(cands) == 1:
        return TunedProgram(fn=build(cands[0]), tiles=cands[0],
                            device=device_key(device), timings_ms={})
    if timer is None:
        raise ValueError(f"a race of {len(cands)} candidates needs a timer")
    lead, hold = None, HOLD_CYCLES
    timings: Dict[TileConfig, float] = {}
    for cand in cands:
        fn = build(cand)
        fn(*args)                                # warm (and capture), untimed
        _finish(device)
        samples = []
        while len(samples) < max(1, reps):
            t, own = _sample(fn, args, device, timer, hold)
            if not own and hold < HOLD_CYCLES_MAX:
                hold *= 2                        # the host outran the spin: spin longer
                continue
            samples.append(t)
        timings[cand] = min(samples)
        if lead is None or _beats(samples, lead[0]):
            lead = (samples, cand, fn)
    return TunedProgram(fn=lead[2], tiles=lead[1], device=device_key(device),
                        timings_ms=timings)
