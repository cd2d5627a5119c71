"""Sparse ternary random projection (paper §III-B, Fox'16 distribution).

R (p × m) is sampled elementwise from

    r_ij = +1  with probability 1/(2s)
            0  with probability 1 - 1/s
           -1  with probability 1/(2s)

with s the projected dimensionality p unless set otherwise.  R is stored as
int8; on the card the CUDA kernel (`repro_torch.kernels.ternary_matmul`)
reads it as int8 and widens it in registers.  This module holds the
distribution, the dense PyTorch path and the kernel dispatch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class RPConfig:
    """Static configuration of a ternary random projection m -> p.

    `normalize` selects the (data-independent) output scale:
      * "isometry": sqrt(s/p) — E‖Rx‖² = ‖x‖² (classic JL isometry)
      * "per_dim":  sqrt(s/m) — each projected dim carries the average
        per-dim variance of the input (keeps a downstream EASI stage in its
        unit-variance regime)
      * None: raw ±1 accumulation (the FPGA add/sub semantics).
    """

    m: int                      # input dimensionality
    p: int                      # output (projected) dimensionality
    sparsity: Optional[int] = None  # `s` above; defaults to p (paper's choice)
    normalize: Optional[str] = "per_dim"
    dtype: Any = torch.float32  # compute dtype of the projection output

    def __post_init__(self):
        if self.p > self.m:
            raise ValueError(f"RP must not increase dimensionality: m={self.m} p={self.p}")
        if self.s < 1:
            raise ValueError(f"sparsity must be >= 1, got {self.s}")
        if self.normalize not in (None, "isometry", "per_dim"):
            raise ValueError(f"unknown normalize mode {self.normalize!r}")

    @property
    def s(self) -> int:
        return self.p if self.sparsity is None else self.sparsity

    @property
    def scale(self) -> float:
        if self.normalize == "isometry":
            return math.sqrt(self.s / self.p)
        if self.normalize == "per_dim":
            return math.sqrt(self.s / self.m)
        return 1.0

    # ---- hardware cost model (paper Table II translation) -----------------
    def expected_nonzeros(self) -> float:
        """E[#nonzero entries of R] = p*m/s — the FPGA add/sub count."""
        return self.p * self.m / self.s

    def bytes_int8(self) -> int:
        return self.p * self.m  # 1 byte per ternary entry

    def bytes_f32(self) -> int:
        return 4 * self.p * self.m


def sample_ternary(generator: torch.Generator, cfg: RPConfig, *,
                   ensure_nonzero_rows: bool = True) -> torch.Tensor:
    """Sample R (p, m) int8 from the paper's ternary distribution, on the
    generator's device.

    `ensure_nonzero_rows`: at the paper's own scale (m=32, s=p=24) a row of R
    is all-zero with probability (1−1/s)^m ≈ 26%, i.e. a dead output wire
    whose whitening update diverges.  Any empty row gets one ±1 planted in a
    uniform column with a fair sign, as in the JAX package.
    """
    dev = generator.device
    u = torch.rand((cfg.p, cfg.m), generator=generator, device=dev)
    half = 1.0 / (2.0 * cfg.s)
    one = torch.ones((), dtype=torch.int8, device=dev)
    r = torch.where(u < half, one,
                    torch.where(u < 2 * half, -one, torch.zeros_like(one)))
    if ensure_nonzero_rows:
        dead = torch.all(r == 0, dim=1)                                  # (p,)
        cols = torch.randint(0, cfg.m, (cfg.p,), generator=generator, device=dev)
        signs = torch.randint(0, 2, (cfg.p,), generator=generator, device=dev) * 2 - 1
        plant = (torch.nn.functional.one_hot(cols, cfg.m) * signs[:, None]).to(torch.int8)
        r = torch.where(dead[:, None], plant, r)
    return r


def _apply_dense(r_int8: torch.Tensor, x: torch.Tensor, scale: float) -> torch.Tensor:
    """Dense path: y = scale * x @ Rᵀ, with R cast to x.dtype and the scale
    applied in x.dtype (as the JAX dense path does)."""
    r = r_int8.to(x.dtype)
    return (x @ r.T) * torch.tensor(scale, dtype=x.dtype)


def apply_rp(r_int8: torch.Tensor, x: torch.Tensor, cfg: RPConfig, *,
             execution=None) -> torch.Tensor:
    """Project x (…, m) -> (…, p).  The kernel backend routes through the
    ternary-matmul kernel; ternary entries are exact in every float dtype,
    so both paths agree to f32 rounding."""
    x2 = x.reshape((-1, cfg.m)).to(cfg.dtype)
    if execution is not None and execution.use_kernel:
        from repro_torch.kernels import ops as kops

        y = kops.ternary_matmul(x2, r_int8, scale=cfg.scale, block_m=execution.tmm_block_m,
                                block_p=execution.tmm_block_p)
    else:
        y = _apply_dense(r_int8, x2, cfg.scale)
    return y.reshape(x.shape[:-1] + (cfg.p,))


def rp_gram_error(r_int8: torch.Tensor, cfg: RPConfig, x: torch.Tensor) -> torch.Tensor:
    """Relative Frobenius error ‖YYᵀ − XXᵀ‖_F / ‖XXᵀ‖_F of the sample Gram
    matrix under projection, in isometry units."""
    y = apply_rp(r_int8, x, cfg)
    iso = math.sqrt(cfg.s / cfg.p)
    y = y * (iso / cfg.scale)
    gx = x @ x.T
    gy = y @ y.T
    return torch.linalg.norm(gy - gx) / (torch.linalg.norm(gx) + 1e-12)
