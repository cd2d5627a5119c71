"""EASI — Equivariant Adaptive Separation via Independence (paper §III-D, Eq. 6).

Separation matrix B (n × m) trained online:

    y   = B x
    B  ←  B − μ [ y yᵀ − I  +  g(y) yᵀ − y g(y)ᵀ ] B          (Eq. 6)

`y yᵀ − I` is the second-order (whitening) term; the skew-symmetric
`g(y) yᵀ − y g(y)ᵀ` injects higher-order statistics.  Both terms are
maskable: whitening (second-order only), full EASI (both) and rotation-only
EASI (higher-order only) share one datapath.

For a block Y (b × n) the update uses the block expectation

    G = (YᵀY)/b − I + (g(Y)ᵀY − Yᵀg(Y))/b,     B ← B − μ G B

which is the per-sample rule at b = 1.  Under the kernel backend the update
runs in the CUDA `easi_apply` kernel (`repro_torch.kernels.easi_update`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

Nonlinearity = Callable[[torch.Tensor], torch.Tensor]

NONLINEARITIES: Dict[str, Nonlinearity] = {
    "cubic": lambda y: y * y * y,            # paper Algorithm 1, line 3
    "tanh": torch.tanh,
    "sign_cubic": lambda y: torch.sign(y) * y * y,
}


@dataclasses.dataclass(frozen=True)
class EASIConfig:
    """Static configuration of one EASI / whitening / rotation stage m -> n."""

    m: int                       # input dim of this stage
    n: int                       # output dim (n <= m)
    mu: float = 1e-3             # learning rate (paper: constant μ_k = μ)
    g: str = "cubic"
    second_order: bool = True    # keep the  y yᵀ − I   whitening term
    higher_order: bool = True    # keep the  g(y)yᵀ − y g(y)ᵀ  HOS term
    normalized: bool = False     # Cardoso's normalized-EASI stabilisation
    init: str = "orthonormal"    # B₀: "orthonormal" | "eye" | "strided"
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.n > self.m:
            raise ValueError(f"EASI must not increase dimensionality: m={self.m} n={self.n}")
        if not (self.second_order or self.higher_order):
            raise ValueError("at least one of second_order/higher_order must be on")
        if self.g not in NONLINEARITIES:
            raise ValueError(f"unknown nonlinearity {self.g!r}")
        if self.init not in ("orthonormal", "eye", "strided"):
            raise ValueError(f"unknown init {self.init!r}")


def init_b(generator: torch.Generator, cfg: EASIConfig) -> torch.Tensor:
    """B₀ on the generator's device.  Eq. 6 multiplies B on the left by an
    n × n matrix, so rowspace(B₀) is kept for all time and the init decides
    which subspace survives the reduction:

      * "orthonormal": QR of a Gaussian — a uniformly random n-subspace
      * "eye":      B₀ = [I_n | 0] — taps the first n input features
      * "strided":  one tap every m/n features
    """
    dev = generator.device
    if cfg.init == "eye":
        return torch.eye(cfg.n, cfg.m, dtype=cfg.dtype, device=dev)
    if cfg.init == "strided":
        # f32 arithmetic and round-half-to-even, as the JAX package computes it
        cols = np.round(np.arange(cfg.n, dtype=np.float32) * np.float32(cfg.m / cfg.n))
        cols = torch.as_tensor(cols.astype(np.int64), device=dev)
        return torch.nn.functional.one_hot(cols, cfg.m).to(cfg.dtype)
    a = torch.randn((cfg.m, cfg.n), generator=generator, dtype=torch.float32, device=dev)
    q, _ = torch.linalg.qr(a)  # (m, n) with orthonormal columns
    return q.T.to(cfg.dtype).contiguous()  # (n, m) orthonormal rows


def relative_gradient(y: torch.Tensor, cfg: EASIConfig) -> torch.Tensor:
    """G (n×n) from a block of outputs y (b, n) — the Eq. 6 bracket."""
    if y.ndim == 1:
        y = y[None, :]
    b, n = y.shape
    inv_b = torch.tensor(1.0 / b, dtype=y.dtype)
    eye = torch.eye(n, dtype=y.dtype, device=y.device)
    gy = NONLINEARITIES[cfg.g](y)
    denom2 = denomh = 1.0
    if cfg.normalized:
        # Cardoso's normalised EASI: divide the 2nd-order term by 1 + μ yᵀy
        # and the HOS term by 1 + μ |yᵀ g(y)| (block-averaged).
        denom2 = 1.0 + cfg.mu * torch.mean(torch.sum(y * y, dim=-1))
        denomh = 1.0 + cfg.mu * torch.abs(torch.mean(torch.sum(y * gy, dim=-1)))
    terms = torch.zeros((n, n), dtype=y.dtype, device=y.device)
    if cfg.second_order:
        c = (y.T @ y) * inv_b
        terms = terms + (c - eye) / denom2 if cfg.normalized else terms + c - eye
    if cfg.higher_order:
        h = (gy.T @ y) * inv_b
        terms = terms + (h - h.T) / denomh if cfg.normalized else terms + h - h.T
    return terms


def easi_step(b_mat: torch.Tensor, x_block: torch.Tensor,
              cfg: EASIConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One EASI update from a raw input block x (b, m). Returns (B', y)."""
    y = x_block.to(b_mat.dtype) @ b_mat.T
    g = relative_gradient(y, cfg)
    return b_mat - cfg.mu * (g @ b_mat), y


def easi_fit(b0: torch.Tensor, x: torch.Tensor, cfg: EASIConfig, *,
             block_size: int = 1, epochs: int = 1, execution=None) -> torch.Tensor:
    """Stream x (N, m) through EASI in blocks; returns the trained B.

    block_size=1 is the paper's per-sample SGD.  Trailing samples that do
    not fill a block are dropped (deterministic, restart-safe).  The kernel
    backend runs each update through `kernels.ops.easi_update`.
    """
    nblocks = x.shape[0] // block_size
    blocks = x[: nblocks * block_size].reshape(nblocks, block_size, cfg.m)
    if execution is not None and execution.use_kernel:
        from repro_torch.kernels import ops as kops

        def step(b_mat, blk):
            return kops.easi_update(b_mat, blk, cfg, block_m=execution.easi_block_m)
    else:
        def step(b_mat, blk):
            return easi_step(b_mat, blk, cfg)[0]

    b_mat = b0
    for _ in range(epochs):
        for blk in blocks:
            b_mat = step(b_mat, blk)
    return b_mat


def transform(b_mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = B x for batched rows x (..., m) -> (..., n)."""
    return x @ b_mat.T


# ---------------------------------------------------------------------------
# Validation metrics
# ---------------------------------------------------------------------------

def whiteness_kl(y: torch.Tensor) -> torch.Tensor:
    """KL(Σ_y ‖ I) = ½(tr Σ − log det Σ − n): the objective Eq. 3 minimises."""
    b, n = y.shape
    cov = y.T @ y / b
    _, logdet = torch.linalg.slogdet(cov)
    return 0.5 * (torch.trace(cov) - logdet - n)


def amari_distance(w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Amari index of P = W A against a scaled permutation (0 = perfect ICA),
    normalised by 2n(n−1)."""
    p = torch.abs(w @ a)
    n = p.shape[0]
    row = torch.sum(p / torch.amax(p, dim=1, keepdim=True), dim=1) - 1.0
    col = torch.sum(p / torch.amax(p, dim=0, keepdim=True), dim=0) - 1.0
    return (torch.sum(row) + torch.sum(col)) / (2.0 * n * (n - 1))
