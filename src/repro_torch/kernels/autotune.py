"""Tile autotuner for the serving engine's bucket programs.

The contract of the JAX package's `kernels/autotune.py`: `DRService` calls
`tune` once per (bucket, device) at registry-register time and stores the
returned `TunedProgram` (built program + winning tiles) in its
`BoundedCompileCache`, so a promote (same config hash → same cache key)
never re-tunes and an eviction drops the program and its tiles together.

  * Candidates are DEDUPED by their *effective* tiles: what the kernels
    actually run after their own choice.  The port's CUDA kernels read no
    tile field of `Execution` yet — each C entry picks its body and tiling
    from the shape and the SM count (`fused_transform.tiles`,
    `ternary_matmul.plan`, `easi_update.plan`) — so every point of a sweep
    has the same effective tiles and the sweep is one candidate: the
    policy's own tiles, which is what a tie would keep.
  * So `tune` builds that one candidate and times nothing.  The sweep
    universes and the timed race (with the service's injected `Clock`)
    come back with ROADMAP A4a, when a kernel is templated over a tile
    field it reads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One (block_m, block_p, block_k) point of the sweep: the
    `Execution.tmm_block_*` fields."""

    block_m: int = 128
    block_p: int = 128
    block_k: int = 512

    def effective(self, rows: int, p: int, m: int) -> "TileConfig":
        """The tiles the kernels run for a (rows, p, m) problem.  They read
        none of these fields and choose their own tiling, so every point
        maps to the same `KERNEL_CHOICE`."""
        return KERNEL_CHOICE


KERNEL_CHOICE = TileConfig(block_m=0, block_p=0, block_k=0)
"""The effective tiles of every candidate: the kernels' own choice."""


def candidates(rows: int, p: int, m: int, *,
               first: Optional[TileConfig] = None) -> Tuple[TileConfig, ...]:
    """The deduped sweep for a (rows, p, m) problem: `first` (the model's
    own Execution tiles), or `KERNEL_CHOICE` without one.  Every other point
    has the same effective tiles, so it would be deduped away."""
    return (first if first is not None else KERNEL_CHOICE,)


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

    def __call__(self, *args: Any, **kw: Any) -> Any:
        return self.fn(*args, **kw)


def tune(cands: Sequence[TileConfig],
         build: Callable[[TileConfig], Callable[..., Any]],
         args: Tuple[Any, ...]) -> TunedProgram:
    """Build the sweep's one candidate; `args` (a bucket-shaped dummy call)
    name the device the program is tuned for."""
    if len(cands) != 1:
        raise NotImplementedError(
            f"a sweep of {len(cands)} candidates needs a timed race, which "
            "comes with the kernels' tile templates (ROADMAP A4a)")
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    return TunedProgram(fn=build(cands[0]), tiles=cands[0],
                        device=device_key(device))
