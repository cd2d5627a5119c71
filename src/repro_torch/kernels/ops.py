"""Public entry points to the kernels, as the DR and LM layers call them.

Each kernel wrapper runs its plain PyTorch version for CPU tensors and the
CUDA kernel for CUDA tensors.  This layer makes the operands contiguous,
keeps the normalized EASI variant on the plain path (as the JAX package
does) and composes the EASI step.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import easi_update as _easi_kernel
from repro_torch.kernels import flash_attention as _flash_kernel
from repro_torch.kernels import fused_transform as _fused_kernel
from repro_torch.kernels import ternary_matmul as _tmm_kernel


def ternary_matmul(x: torch.Tensor, r_int8: torch.Tensor, *, scale: float = 1.0,
                   block_m: int = 128, block_p: int = 128):
    """scale · x Rᵀ; the tiles are an `Execution`'s `tmm_block_m` / `tmm_block_p`."""
    return _tmm_kernel.ternary_matmul(x.contiguous(), r_int8.contiguous(), scale=scale,
                                      block_m=block_m, block_p=block_p)


def fused_transform(x: torch.Tensor, r_int8: torch.Tensor, b_mat: torch.Tensor, *,
                    scale: float = 1.0, block_m: int = 128, block_p: int = 128):
    """Fused project + whiten: (scale · x Rᵀ) Bᵀ in one kernel (the serve
    transform hot path); the tiles are an `Execution`'s `tmm_block_m` /
    `tmm_block_p`."""
    return _fused_kernel.fused_transform(x.contiguous(), r_int8.contiguous(),
                                         b_mat.contiguous(), scale=scale, block_m=block_m,
                                         block_p=block_p)


def easi_apply(b_mat: torch.Tensor, y: torch.Tensor, cfg, block_m: int = 512):
    """Apply one EASI update given precomputed outputs y (b, n); `block_m`
    is B's column tile, an `Execution`'s `easi_block_m`."""
    if cfg.normalized:
        # The normalized variant divides by data-dependent scalars; it stays
        # on the plain path (it is not the datapath the paper builds).
        from repro_torch.core import easi as easi_mod

        g = easi_mod.relative_gradient(y, cfg)
        return b_mat - cfg.mu * (g @ b_mat)
    return _easi_kernel.easi_apply(
        b_mat.contiguous(), y.contiguous(), mu=cfg.mu, second_order=cfg.second_order,
        higher_order=cfg.higher_order, g_name=cfg.g, block_m=block_m)


def easi_update(b_mat: torch.Tensor, h_block: torch.Tensor, cfg, block_m: int = 512):
    """Full step: y = h Bᵀ (a plain matmul, as XLA computed it outside any
    Pallas kernel), then the fused gradient + update kernel."""
    y = h_block.to(b_mat.dtype) @ b_mat.T
    return easi_apply(b_mat, y, cfg, block_m)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, return_lse: bool = False,
                    scale: Optional[float] = None):
    """Flash attention forward: q (B, Sq, Hq, Dh), k/v (B, Skv, Hkv, Dh) ->
    (B, Sq, Hq, Dh), and with `return_lse` also each row's log-sum-exp (B,
    Hq, Sq) in f32.  The kernel reads the (B, S, H, Dh) layout as it is, so
    no head-major copy is made; the operands are only made contiguous."""
    return _flash_kernel.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                         causal=causal, window=window, q_offset=q_offset,
                                         return_lse=return_lse, scale=scale)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        scale: Optional[float] = None):
    """Flash attention backward from the forward's out and lse: (dq, dk, dv)
    in the inputs' dtype (the CUDA kernel takes bf16).  The operands are only
    made contiguous."""
    return _flash_kernel.flash_attention_bwd(
        q.contiguous(), k.contiguous(), v.contiguous(), out.contiguous(), lse.contiguous(),
        dout.contiguous(), causal=causal, window=window, q_offset=q_offset, scale=scale)
