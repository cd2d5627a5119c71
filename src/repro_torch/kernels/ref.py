"""Plain PyTorch versions of every ported kernel (the correctness ground
truth).  The wrappers run these for CPU tensors; `chip_smoke.py` holds each
CUDA kernel against them on the card.  f32 throughout, as the JAX oracles."""

from __future__ import annotations

import torch


def ternary_matmul_ref(x: torch.Tensor, r_int8: torch.Tensor, *,
                       scale: float = 1.0) -> torch.Tensor:
    """y (b, p) = scale * x @ rᵀ with f32 accumulation."""
    y = x.to(torch.float32) @ r_int8.to(torch.float32).T * scale
    return y.to(x.dtype)


def fused_transform_ref(x: torch.Tensor, r_int8: torch.Tensor,
                        b_mat: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
    """out (b, n) = (scale * x @ rᵀ) @ bᵀ — the project-then-whiten serve
    transform as two plain products with f32 accumulation.

    The (b, p) intermediate stays in f32, as in the TPU kernel and the CUDA
    kernel.  (The JAX oracle rounds it to x.dtype first; at bf16 that alone
    moves some outputs by more than 2e-2.)"""
    y = x.to(torch.float32) @ r_int8.to(torch.float32).T * scale
    out = y @ b_mat.to(torch.float32).T
    return out.to(b_mat.dtype)


def nonlinearity(g_name: str, v: torch.Tensor) -> torch.Tensor:
    if g_name == "cubic":
        return v ** 3
    if g_name == "tanh":
        return torch.tanh(v)
    if g_name == "sign_cubic":
        return torch.sign(v) * v * v
    raise ValueError(f"unknown nonlinearity {g_name!r}")


def easi_apply_ref(b_mat: torch.Tensor, y: torch.Tensor, *, mu: float,
                   second_order: bool = True, higher_order: bool = True,
                   g_name: str = "cubic") -> torch.Tensor:
    """Reference EASI update: B − μ[(YᵀY/b − I)·so + (H − Hᵀ)·ho]B."""
    y32 = y.to(torch.float32)
    b, n = y32.shape
    g_mat = torch.zeros((n, n), dtype=torch.float32, device=y.device)
    if second_order:
        g_mat += y32.T @ y32 / b - torch.eye(n, dtype=torch.float32, device=y.device)
    if higher_order:
        h = nonlinearity(g_name, y32).T @ y32 / b
        g_mat += h - h.T
    b32 = b_mat.to(torch.float32)
    out = b32 - mu * (g_mat @ b32)
    return out.to(b_mat.dtype)
