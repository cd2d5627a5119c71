"""Plain PyTorch versions of every ported kernel (the correctness ground
truth).  The wrappers run these for CPU tensors; `chip_smoke.py` holds each
CUDA kernel against them on the card.  f32 throughout, as the JAX oracles."""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0, q_chunk: int = 1024,
                        kv_chunk: int = 1024) -> torch.Tensor:
    """Double-chunked online-softmax attention forward, the arithmetic of
    the JAX package's `blocks._flash_forward`: q (B, Sq, Hq, Dh), k and v
    (B, Skv, Hkv, Dh), query row r at position q_offset + r, query head h
    reading kv head h // (Hq / Hkv).  Scores, max, sum and accumulator are
    f32; p is rounded to v's dtype before the p·v product; the output is in
    q's dtype.

    Masked entries get p = 0 (the reference computes exp(−1e30 − m), which
    is 0 wherever the row has seen a key, and 1 before it has).  So a row
    that sees some key gets the reference's value, a row that sees none
    gets 0, and no value depends on the chunking.  Chunk pairs that the
    mask hides entirely are skipped."""
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    cq, ck = max(1, min(q_chunk, sq)), max(1, min(kv_chunk, skv))
    dev = q.device
    out = torch.zeros((b, sq, hq, dh), dtype=q.dtype, device=dev)
    kh = k.to(torch.float32).permute(0, 2, 1, 3)          # (b, hkv, skv, dh)
    vh = v.to(torch.float32).permute(0, 2, 1, 3)
    for q0 in range(0, sq, cq):
        q1 = min(q0 + cq, sq)
        n = q1 - q0
        qb = q[:, q0:q1].to(torch.float32).reshape(b, n, hkv, g, dh).permute(0, 2, 3, 1, 4)
        q_pos = q_offset + torch.arange(q0, q1, device=dev)
        acc = torch.zeros((b, hkv, g, n, dh), dtype=torch.float32, device=dev)
        m_run = torch.full((b, hkv, g, n), NEG_INF, dtype=torch.float32, device=dev)
        l_run = torch.zeros((b, hkv, g, n), dtype=torch.float32, device=dev)
        for k0 in range(0, skv, ck):
            k1 = min(k0 + ck, skv)
            if causal and k0 > q_offset + q1 - 1:
                break
            if window is not None and q_offset + q0 - (k1 - 1) >= window:
                continue
            k_pos = torch.arange(k0, k1, device=dev)
            mask = torch.ones((n, k1 - k0), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= q_pos[:, None] - k_pos[None, :] < window
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kh[:, :, k0:k1]) * scale
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(v.dtype).to(torch.float32), vh[:, :, k0:k1])
            m_run = m_new
        res = acc / torch.clamp(l_run, min=1e-30)[..., None]
        out[:, q0:q1] = res.permute(0, 3, 1, 2, 4).reshape(b, n, hq, dh).to(q.dtype)
    return out
