"""Composable DR stages — the paper's datapath personalities as building
blocks of a reduction chain m → p₁ → … → n:

    EASIStage.whiten(m, n)    — Eq. 3 adaptive PCA whitening  (2nd only)
    EASIStage.rotation(m, n)  — Eq. 5 rotation-only EASI      (HOS only)
    EASIStage.full(m, n)      — Eq. 6 full EASI ICA           (both)
    RPStage(m, p)             — §III-B static ternary random projection

Stages are frozen configs; their state is a bare tensor (int8 R for RP,
float B for EASI) held in an explicit `ModelState`.  All compute routes
through the `Execution` policy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Protocol, runtime_checkable

import torch

from repro_torch.core import easi as easi_mod
from repro_torch.core import random_projection as rp_mod
from repro_torch.core.execution import Execution


@runtime_checkable
class Stage(Protocol):
    """One m→n link of a reduction cascade.  `trainable` distinguishes
    adaptive stages (streamed `update`) from static ones (sampled once at
    `init`, `update` is the identity)."""

    @property
    def in_dim(self) -> int: ...

    @property
    def out_dim(self) -> int: ...

    @property
    def trainable(self) -> bool: ...

    def init(self, generator: torch.Generator, exe: Execution) -> torch.Tensor: ...

    def transform(self, state: torch.Tensor, x: torch.Tensor, exe: Execution) -> torch.Tensor: ...

    def update(self, state: torch.Tensor, x: torch.Tensor, exe: Execution) -> torch.Tensor: ...

    def mac_counts(self) -> Dict[str, float]: ...

    def shard_spec(self, mesh) -> tuple: ...


def _dtype(stage_dtype, exe: Execution):
    return stage_dtype if stage_dtype is not None else exe.dtype


# ---------------------------------------------------------------------------
# static ternary random projection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RPStage:
    """Sparse ternary random projection m → p (static; trained never)."""

    m: int
    p: int
    sparsity: Optional[int] = None      # defaults to p (paper's s = p)
    normalize: Optional[str] = "per_dim"
    dtype: Optional[Any] = None         # None → inherit Execution.dtype

    @property
    def in_dim(self) -> int:
        return self.m

    @property
    def out_dim(self) -> int:
        return self.p

    @property
    def trainable(self) -> bool:
        return False

    def rp_cfg(self, exe: Execution) -> rp_mod.RPConfig:
        return rp_mod.RPConfig(m=self.m, p=self.p, sparsity=self.sparsity,
                               normalize=self.normalize, dtype=_dtype(self.dtype, exe))

    def init(self, generator: torch.Generator, exe: Execution) -> torch.Tensor:
        return rp_mod.sample_ternary(generator, self.rp_cfg(exe)).to(exe.torch_device())

    def transform(self, state: torch.Tensor, x: torch.Tensor, exe: Execution) -> torch.Tensor:
        return rp_mod.apply_rp(state, x, self.rp_cfg(exe), execution=exe)

    def update(self, state: torch.Tensor, x: torch.Tensor, exe: Execution) -> torch.Tensor:
        return state

    def mac_counts(self) -> Dict[str, float]:
        cfg = self.rp_cfg(Execution())
        return {"adds": cfg.expected_nonzeros(), "macs": 0.0}

    def shard_spec(self, mesh) -> tuple:
        return (None, None)  # int8 (p, m): tiny — replicate


# ---------------------------------------------------------------------------
# adaptive EASI / whitening / rotation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EASIStage:
    """Adaptive stage m → n running the Eq. 6 datapath; the two term flags
    are the paper's multiplexer (whiten / rotation / full EASI)."""

    m: int
    n: int
    mu: float = 1e-3
    g: str = "cubic"
    second_order: bool = True
    higher_order: bool = True
    normalized: bool = False
    init_mode: str = "orthonormal"      # see easi.init_b
    dtype: Optional[Any] = None

    # -- named personalities -------------------------------------------------
    @classmethod
    def whiten(cls, m: int, n: int, **kw) -> "EASIStage":
        return cls(m=m, n=n, second_order=True, higher_order=False, **kw)

    @classmethod
    def rotation(cls, m: int, n: int, **kw) -> "EASIStage":
        return cls(m=m, n=n, second_order=False, higher_order=True, **kw)

    @classmethod
    def full(cls, m: int, n: int, **kw) -> "EASIStage":
        return cls(m=m, n=n, second_order=True, higher_order=True, **kw)

    @property
    def in_dim(self) -> int:
        return self.m

    @property
    def out_dim(self) -> int:
        return self.n

    @property
    def trainable(self) -> bool:
        return True

    def easi_cfg(self, exe: Execution) -> easi_mod.EASIConfig:
        return easi_mod.EASIConfig(
            m=self.m, n=self.n, mu=self.mu, g=self.g,
            second_order=self.second_order, higher_order=self.higher_order,
            normalized=self.normalized, init=self.init_mode,
            dtype=_dtype(self.dtype, exe))

    def init(self, generator: torch.Generator, exe: Execution) -> torch.Tensor:
        return easi_mod.init_b(generator, self.easi_cfg(exe)).to(exe.torch_device())

    def transform(self, state: torch.Tensor, x: torch.Tensor, exe: Execution) -> torch.Tensor:
        # cast to the stage's compute dtype (bf16 stages must not silently
        # promote to f32 when fed raw f32 features)
        return easi_mod.transform(state, x.to(_dtype(self.dtype, exe)))

    def update(self, state: torch.Tensor, x: torch.Tensor, exe: Execution) -> torch.Tensor:
        cfg = self.easi_cfg(exe)
        if exe.use_kernel:
            from repro_torch.kernels import ops as kops

            return kops.easi_update(state, x, cfg, block_m=exe.easi_block_m)
        return easi_mod.easi_step(state, x, cfg)[0]

    def fit_stream(self, state: torch.Tensor, x: torch.Tensor, exe: Execution, *,
                   block_size: int, epochs: int) -> torch.Tensor:
        """Stream a whole dataset through this stage."""
        return easi_mod.easi_fit(state, x, self.easi_cfg(exe), block_size=block_size,
                                 epochs=epochs, execution=exe)

    def mac_counts(self) -> Dict[str, float]:
        """Paper Table II cost model: Θ(m·n²) MACs per processed sample."""
        m, n = self.m, self.n
        mv = n * m                                     # y = Bx
        nl = 2 * n if self.higher_order else 0         # cubic g(y)
        outer = (n * n if self.second_order else 0) \
            + (2 * n * n if self.higher_order else 0)  # yyᵀ / g(y)yᵀ − yg(y)ᵀ
        gradb = n * n * m                              # G @ B
        upd = n * m                                    # B − μ(·)
        return {"adds": 0.0, "macs": float(mv + nl + outer + gradb + upd)}

    def shard_spec(self, mesh) -> tuple:
        return (None, None)  # B (n, m): small — replicate


# ---------------------------------------------------------------------------
# fused RP→EASI serve transform
# ---------------------------------------------------------------------------

def fused_pair_transform(rp: RPStage, easi: EASIStage, r_state: torch.Tensor,
                         b_state: torch.Tensor, x: torch.Tensor,
                         exe: Execution) -> torch.Tensor:
    """Project-then-whiten x (…, m) → (…, n) through ONE kernel launch.

    Semantically `rp.transform` followed by `easi.transform`: EASI's
    deployment transform is x @ Bᵀ whatever its update flags, so all three
    personalities fuse the same way.
    """
    from repro_torch.kernels import ops as kops

    cfg = rp.rp_cfg(exe)
    x2 = x.reshape((-1, cfg.m)).to(cfg.dtype)
    y = kops.fused_transform(x2, r_state, b_state, scale=cfg.scale, block_m=exe.tmm_block_m,
                             block_p=exe.tmm_block_p)
    return y.reshape(x.shape[:-1] + (easi.n,))
