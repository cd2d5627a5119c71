"""Legacy facade over the composable stage API (paper §IV).

The JAX package's `core/dr_unit.py`, in PyTorch.  The reconfigurable DR
unit used to be a six-way string enum (`kind` ∈ rp | whiten | easi |
rotation | rp_easi | rp_whiten); the datapath is now built from stages in
`repro_torch.dr`, and this module keeps the old call signatures alive as a
thin shim:

    cfg   = DRConfig(kind="rp_easi", m=32, p=16, n=8)
    model = from_legacy(cfg)                  # the composable equivalent
    state = init(generator, cfg)
    state = fit(state, cfg, x, epochs=3)

Every function delegates to the `DRModel` built by `from_legacy`, so the
kind table exists once (`repro_torch.dr.legacy`).  `init` takes the
`Execution` that places the state (the card unless it says the CPU); the
reference's `init(key, cfg)` needs none, since JAX places arrays itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import easi as easi_mod
from repro_torch.core import random_projection as rp_mod
from repro_torch.core.execution import Execution, resolve

KINDS = ("rp", "whiten", "easi", "rotation", "rp_easi", "rp_whiten")


@dataclasses.dataclass(frozen=True)
class DRConfig:
    kind: str
    m: int                          # input feature dim
    n: int                          # output (reduced) dim
    p: Optional[int] = None         # intermediate dim (rp_* kinds only)
    mu: float = 1e-3
    g: str = "cubic"
    bypass_whitening: bool = True   # paper's modified datapath for rp_easi
    normalized: bool = False
    rp_sparsity: Optional[int] = None
    block_size: int = 1             # samples per update block (1 = paper-exact)
    init: str = "orthonormal"       # B₀ subspace choice — see easi.init_b
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown DR kind {self.kind!r}; one of {KINDS}")
        if self.kind.startswith("rp_") and self.p is None:
            raise ValueError(f"kind={self.kind} requires intermediate dim p")
        if self.kind.startswith("rp_") and not (self.m >= self.p >= self.n):
            raise ValueError(f"need m >= p >= n, got {self.m}/{self.p}/{self.n}")

    # ---- derived stage configs (read off the stage composition) -----------
    @property
    def rp_cfg(self) -> Optional[rp_mod.RPConfig]:
        from repro_torch.dr.stages import RPStage

        model = from_legacy(self)
        for stage in model.stages:
            if isinstance(stage, RPStage):
                return stage.rp_cfg(model.execution)
        return None

    @property
    def easi_cfg(self) -> Optional[easi_mod.EASIConfig]:
        from repro_torch.dr.stages import EASIStage

        model = from_legacy(self)
        for stage in model.stages:
            if isinstance(stage, EASIStage):
                return stage.easi_cfg(model.execution)
        return None

    # ---- paper Table II cost model (MAC counts) ---------------------------
    def mac_counts(self) -> dict:
        """Adder/multiplier-equivalent counts per processed sample, summed
        over the stage composition."""
        mac = from_legacy(self).mac_counts()
        return {"rp_adds": mac["rp_adds"], "easi_macs": mac["easi_macs"]}


class DRState(NamedTuple):
    """Learnable/static state of a DR unit."""

    r: Optional[torch.Tensor]   # int8 ternary (p|n, m) or None
    b: Optional[torch.Tensor]   # f32 separation/whitening matrix (n, p|m) or None
    steps: torch.Tensor         # int32 scalar update counter (host)


# ---------------------------------------------------------------------------
# the shim: DRConfig → DRModel
# ---------------------------------------------------------------------------

def from_legacy(cfg: DRConfig, *, execution: Optional[Execution] = None,
                use_kernel: bool = False):
    """The composable `repro_torch.dr.DRModel` equivalent of a legacy config."""
    from repro_torch.dr import legacy

    return legacy.model_from_config(cfg, execution=resolve(execution, use_kernel))


def _pack(mstate) -> DRState:
    from repro_torch.dr import legacy

    r, b, steps = legacy.model_to_legacy_fields(mstate)
    return DRState(r=r, b=b, steps=steps)


def _unpack(model, state: DRState):
    from repro_torch.dr import legacy

    return legacy.legacy_to_model_state(model, state)


# ---------------------------------------------------------------------------
# legacy call surface
# ---------------------------------------------------------------------------

def init(generator: torch.Generator, cfg: DRConfig, *,
         execution: Optional[Execution] = None) -> DRState:
    """Draw the unit's state from `generator`, placed by `execution`."""
    return _pack(from_legacy(cfg, execution=execution).init(generator))


def sample_r(generator: torch.Generator, cfg: DRConfig) -> Optional[torch.Tensor]:
    """R on the generator's device, or None for a kind without RP."""
    return rp_mod.sample_ternary(generator, cfg.rp_cfg) if cfg.rp_cfg is not None else None


def transform(state: DRState, cfg: DRConfig, x, *,
              use_kernel: bool = False, execution: Optional[Execution] = None) -> torch.Tensor:
    """Inference: x (..., m) -> reduced features (..., n)."""
    model = from_legacy(cfg, execution=resolve(execution, use_kernel))
    return model.transform(_unpack(model, state), x)


def update(state: DRState, cfg: DRConfig, x_block, *,
           use_kernel: bool = False, execution: Optional[Execution] = None) -> DRState:
    """One unsupervised training step on a block x (b, m)."""
    model = from_legacy(cfg, execution=resolve(execution, use_kernel))
    return _pack(model.update(_unpack(model, state), x_block))


def fit(state: DRState, cfg: DRConfig, x, *, epochs: int = 1,
        use_kernel: bool = False, execution: Optional[Execution] = None) -> DRState:
    """Stream a dataset x (N, m) through `update` in cfg.block_size blocks."""
    model = from_legacy(cfg, execution=resolve(execution, use_kernel))
    return _pack(model.fit(_unpack(model, state), x, epochs=epochs))
