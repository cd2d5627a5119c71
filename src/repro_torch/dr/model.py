"""`DRModel` — a cascade of DR stages behind one train/serve API:

    model = DRModel(stages=(RPStage(32, 16), EASIStage.rotation(16, 8)),
                    execution=Execution(backend="kernel"), block_size=32)
    state = model.init(torch.Generator().manual_seed(0))
    state = model.fit(state, x, epochs=3)       # unsupervised streaming
    y     = model.transform(state, x)           # deployment

`model.ensemble(k)` trains and serves k independent members of one model
(seed sweeps / scenario diversity) behind the same API.

The execution policy (backend, device, dtype) is fixed at construction.
Every entry point runs on `execution.device` — the card unless the caller
asks for the CPU — and under `torch.no_grad()`: no DR path needs autograd.
State is explicit (`ModelState`) so a server can hold a live and a staged
state side by side and feed either to the same model.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.execution import Execution
from repro_torch.dr.stages import EASIStage, RPStage, Stage, fused_pair_transform


class ModelState:
    """Per-stage states (bare tensors) + an update counter.

    `trainable` is a static per-stage bool mask recorded by the `DRModel`
    that built the state, so the `r`/`b` accessors resolve by stage type
    (first non-trainable / last trainable stage) instead of sniffing
    dtypes.  `steps` is an int32 scalar tensor on the host: the device never
    reads it.
    """

    __slots__ = ("stages", "steps", "trainable")

    def __init__(self, stages: Tuple[Any, ...], steps: torch.Tensor,
                 trainable: Optional[Tuple[bool, ...]] = None):
        self.stages = tuple(stages)
        self.steps = steps
        self.trainable = None if trainable is None else tuple(trainable)

    def _replace(self, **kw) -> "ModelState":
        out = ModelState(stages=kw.pop("stages", self.stages),
                         steps=kw.pop("steps", self.steps),
                         trainable=kw.pop("trainable", self.trainable))
        if kw:
            raise ValueError(f"Got unexpected field names: {sorted(kw)}")
        return out

    def __repr__(self):
        return (f"ModelState(stages={self.stages!r}, steps={self.steps!r}, "
                f"trainable={self.trainable!r})")

    @property
    def r(self) -> Optional[torch.Tensor]:
        """The first static (non-trainable) stage's matrix — RP's ternary R
        in every paper configuration — if any."""
        if self.trainable is not None:
            for s, t in zip(self.stages, self.trainable):
                if not t:
                    return s
            return None
        return self._sniff(static=True)

    @property
    def b(self) -> Optional[torch.Tensor]:
        """The last trainable stage's matrix — the adaptive separation /
        whitening B — if any."""
        if self.trainable is not None:
            for s, t in zip(reversed(self.stages), reversed(self.trainable)):
                if t:
                    return s
            return None
        return self._sniff(static=False)

    def _sniff(self, *, static: bool) -> Optional[torch.Tensor]:
        # Fallback for states built without a mask: the dtype heuristic.
        order = self.stages if static else tuple(reversed(self.stages))
        for s in order:
            if not isinstance(s, torch.Tensor):
                continue
            if static and s.dtype == torch.int8:
                return s
            if not static and s.dtype.is_floating_point:
                return s
        return None


def _as_input(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return torch.as_tensor(x).to(device)


@dataclasses.dataclass(frozen=True)
class DRModel:
    stages: Tuple[Stage, ...]
    execution: Execution = Execution()
    block_size: int = 1          # samples per update block (1 = paper-exact)

    def __post_init__(self):
        if not self.stages:
            raise ValueError("DRModel needs at least one stage")
        for a, b in zip(self.stages, self.stages[1:]):
            if a.out_dim != b.in_dim:
                raise ValueError(
                    f"stage dims do not chain: {type(a).__name__}(->{a.out_dim}) "
                    f"feeds {type(b).__name__}({b.in_dim}->)")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")

    # ---- shape metadata ----------------------------------------------------
    @property
    def in_dim(self) -> int:
        return self.stages[0].in_dim

    @property
    def out_dim(self) -> int:
        return self.stages[-1].out_dim

    @property
    def dims(self) -> Tuple[int, ...]:
        return (self.in_dim,) + tuple(s.out_dim for s in self.stages)

    @property
    def trainable_mask(self) -> Tuple[bool, ...]:
        return tuple(s.trainable for s in self.stages)

    def with_execution(self, exe: Execution) -> "DRModel":
        return dataclasses.replace(self, execution=exe)

    # ---- lifecycle ---------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> ModelState:
        """Draw every stage's state from one generator, stage by stage, and
        place it on the execution device.  The draws differ from the JAX
        package's; parity tests import the reference's state instead."""
        self.execution.torch_device()
        states = tuple(stage.init(generator, self.execution) for stage in self.stages)
        return ModelState(stages=states, steps=torch.zeros((), dtype=torch.int32),
                          trainable=self.trainable_mask)

    # ---- inference ---------------------------------------------------------
    @torch.no_grad()
    def transform(self, state: ModelState, x) -> torch.Tensor:
        """x (..., m) → reduced features (..., n).

        Under the kernel backend every adjacent RPStage→EASIStage pair runs
        the fused project + whiten kernel; remaining stages run stage-wise.
        The torch backend is the stage-wise reference path."""
        exe = self.execution
        h = _as_input(x, exe.torch_device())
        i, n = 0, len(self.stages)
        while i < n:
            stage = self.stages[i]
            if (exe.use_kernel and i + 1 < n and isinstance(stage, RPStage)
                    and isinstance(self.stages[i + 1], EASIStage)):
                h = fused_pair_transform(stage, self.stages[i + 1],
                                         state.stages[i], state.stages[i + 1], h, exe)
                i += 2
                continue
            h = stage.transform(state.stages[i], h, exe)
            i += 1
        return h

    # ---- streaming training ------------------------------------------------
    @torch.no_grad()
    def update(self, state: ModelState, x_block) -> ModelState:
        """One unsupervised step on a block (b, m): every adaptive stage
        updates from its own input, computed through the pre-update states
        upstream (the per-sample Eq. 6 semantics, stage-wise)."""
        h = _as_input(x_block, self.execution.torch_device())
        new_states = _update_stages(self.stages, state.stages, h, self.execution)
        return ModelState(stages=new_states, steps=state.steps + 1,
                          trainable=self.trainable_mask)

    @torch.no_grad()
    def fit(self, state: ModelState, x, *, epochs: int = 1) -> ModelState:
        """Stream a dataset x (N, m) through `update` in block_size blocks.

        Static leading stages project the whole dataset once (they never
        change); the adaptive suffix then runs over it block by block.  A
        suffix of exactly one EASI stage takes the `easi_fit` path.  Trailing
        samples that do not fill a block are dropped.
        """
        exe = self.execution
        x = _as_input(x, exe.torch_device())
        n_samples = x.shape[0]
        h = x
        i = 0
        while i < len(self.stages) and not self.stages[i].trainable:
            h = self.stages[i].transform(state.stages[i], h, exe)
            i += 1

        if i == len(self.stages):   # fully static chain: nothing to train
            nblocks = epochs * (n_samples // max(1, self.block_size))
            return state._replace(steps=state.steps + nblocks)

        suffix = self.stages[i:]
        nblocks = epochs * (n_samples // self.block_size)
        if len(suffix) == 1 and isinstance(suffix[0], EASIStage):
            b = suffix[0].fit_stream(state.stages[i], h, exe,
                                     block_size=self.block_size, epochs=epochs)
            return ModelState(stages=state.stages[:i] + (b,),
                              steps=state.steps + nblocks,
                              trainable=self.trainable_mask)

        # general cascade: run the blocks through the adaptive suffix
        per_epoch = n_samples // self.block_size
        blocks = h[: per_epoch * self.block_size].reshape(
            per_epoch, self.block_size, suffix[0].in_dim)
        carry = tuple(state.stages[i:])
        for _ in range(epochs):
            for blk in blocks:
                carry = _update_stages(suffix, carry, blk, exe)
        return ModelState(stages=tuple(state.stages[:i]) + carry,
                          steps=state.steps + nblocks,
                          trainable=self.trainable_mask)

    # ---- cost model / sharding ---------------------------------------------
    def mac_counts(self) -> Dict[str, Any]:
        """Aggregate paper-Table-II cost: RP adds + adaptive-stage MACs per
        processed sample, plus the per-stage breakdown."""
        per_stage = tuple(s.mac_counts() for s in self.stages)
        return {
            "rp_adds": float(sum(c["adds"] for c in per_stage)),
            "easi_macs": float(sum(c["macs"] for c in per_stage)),
            "per_stage": per_stage,
        }

    def shard_specs(self, mesh) -> ModelState:
        """Specs shaped like a `ModelState` (`repro_torch.dist.sharding`):
        every stage state replicated, as the reference's."""
        return ModelState(stages=tuple(s.shard_spec(mesh) for s in self.stages),
                          steps=(), trainable=self.trainable_mask)

    # ---- ensembling --------------------------------------------------------
    def ensemble(self, k: int) -> "DREnsemble":
        return DREnsemble(model=self, k=k)


def _update_stages(stages, states, h, exe: Execution) -> Tuple[Any, ...]:
    """Update each stage from its input through the pre-update states.  The
    last stage's output feeds nothing, so it is not computed (under jit the
    JAX package drops it as dead code)."""
    new = []
    for i, (stage, s) in enumerate(zip(stages, states)):
        new.append(stage.update(s, h, exe))
        if i + 1 < len(stages):
            h = stage.transform(s, h, exe)
    return tuple(new)


def member(state: ModelState, i: int) -> ModelState:
    """Member i of an ensemble state (views of its stage tensors)."""
    return ModelState(stages=tuple(None if s is None else s[i] for s in state.stages),
                      steps=state.steps[i], trainable=state.trainable)


def stack_members(states: Tuple[ModelState, ...]) -> ModelState:
    """k member states as one ensemble state: a leading (k,) axis on every
    leaf, the step counters a (k,) host tensor."""
    stages = tuple(None if ss[0] is None else torch.stack(ss)
                   for ss in zip(*(st.stages for st in states)))
    return ModelState(stages=stages, steps=torch.stack([st.steps for st in states]),
                      trainable=states[0].trainable)


@dataclasses.dataclass(frozen=True)
class DREnsemble:
    """k independent replicas of one `DRModel` — the reference's vmapped
    ensemble.  States carry a leading (k,) axis on every leaf; data is
    shared across members (each differs only in its init).

    The members run one after another through the model's own entry
    points, so each member's result is the one it would get alone (the same
    kernels on the same tensors).  One launch with a grid axis over the
    members is later kernel work."""

    model: DRModel
    k: int

    def __post_init__(self):
        if self.k < 1:
            raise ValueError("ensemble size must be >= 1")

    @property
    def execution(self) -> Execution:
        return self.model.execution

    def members(self, state: ModelState) -> Tuple[ModelState, ...]:
        n = state.steps.shape[0] if state.steps.ndim else 0
        if n != self.k:
            raise ValueError(f"an ensemble of {self.k} takes a state with a leading ({self.k},) "
                             f"axis; got steps of shape {tuple(state.steps.shape)}")
        return tuple(member(state, i) for i in range(self.k))

    def init(self, generator: torch.Generator) -> ModelState:
        """Member i draws after members 0..i-1, from one generator."""
        return stack_members(tuple(self.model.init(generator) for _ in range(self.k)))

    def update(self, state: ModelState, x_block) -> ModelState:
        return stack_members(tuple(self.model.update(s, x_block) for s in self.members(state)))

    def fit(self, state: ModelState, x, *, epochs: int = 1) -> ModelState:
        return stack_members(tuple(self.model.fit(s, x, epochs=epochs)
                                   for s in self.members(state)))

    def transform(self, state: ModelState, x) -> torch.Tensor:
        """x (..., m) → (k, ..., n)."""
        return torch.stack([self.model.transform(s, x) for s in self.members(state)])
