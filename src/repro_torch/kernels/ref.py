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


def _visible(q0, q1, k0, k1, *, causal, window, q_offset, device):
    """The (q1 - q0, k1 - k0) mask of the keys each query row of the chunk
    pair sees, or None when it hides the pair entirely."""
    if causal and k0 > q_offset + q1 - 1:
        return None
    if window is not None and q_offset + q0 - (k1 - 1) >= window:
        return None
    q_pos = q_offset + torch.arange(q0, q1, device=device)
    k_pos = torch.arange(k0, k1, device=device)
    mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    return mask


def _chunks(n: int, c: int):
    c = max(1, min(c, n))
    return [(a, min(a + c, n)) for a in range(0, n, c)]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0, q_chunk: int = 1024,
                        kv_chunk: int = 1024, return_lse: bool = False,
                        scale: Optional[float] = None):
    """Double-chunked online-softmax attention forward, the arithmetic of
    the JAX package's `blocks._flash_forward`: q (B, Sq, Hq, Dh), k and v
    (B, Skv, Hkv, Dh), query row r at position q_offset + r, query head h
    reading kv head h // (Hq / Hkv).  Scores, max, sum and accumulator are
    f32; p is rounded to v's dtype before the p·v product; the output is in
    q's dtype.  With `return_lse`, (out, lse): lse (B, Hq, Sq) f32 is each
    row's m + log(max(l, 1e-30)), the residual of the reference's VJP.

    The scores are scaled by `scale` (default 1/√Dh).

    Masked entries get p = 0 (the reference computes exp(−1e30 − m), which
    is 0 wherever the row has seen a key, and 1 before it has).  So a row
    that sees some key gets the reference's value, a row that sees none
    gets 0 (and an lse of about −1e30), and no value depends on the
    chunking.  Chunk pairs that the mask hides entirely are skipped."""
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    dev = q.device
    out = torch.zeros((b, sq, hq, dh), dtype=q.dtype, device=dev)
    lse = torch.empty((b, hkv, g, sq), dtype=torch.float32, device=dev) if return_lse else None
    kh = k.to(torch.float32).permute(0, 2, 1, 3)          # (b, hkv, skv, dh)
    vh = v.to(torch.float32).permute(0, 2, 1, 3)
    for q0, q1 in _chunks(sq, q_chunk):
        n = q1 - q0
        qb = q[:, q0:q1].to(torch.float32).reshape(b, n, hkv, g, dh).permute(0, 2, 3, 1, 4)
        acc = torch.zeros((b, hkv, g, n, dh), dtype=torch.float32, device=dev)
        m_run = torch.full((b, hkv, g, n), NEG_INF, dtype=torch.float32, device=dev)
        l_run = torch.zeros((b, hkv, g, n), dtype=torch.float32, device=dev)
        for k0, k1 in _chunks(skv, kv_chunk):
            mask = _visible(q0, q1, k0, k1, causal=causal, window=window, q_offset=q_offset,
                            device=dev)
            if mask is None:
                continue
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kh[:, :, k0:k1]) * scale
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(v.dtype).to(torch.float32), vh[:, :, k0:k1])
            m_run = m_new
        l_safe = torch.clamp(l_run, min=1e-30)
        res = acc / l_safe[..., None]
        out[:, q0:q1] = res.permute(0, 3, 1, 2, 4).reshape(b, n, hq, dh).to(q.dtype)
        if return_lse:
            lse[..., q0:q1] = m_run + torch.log(l_safe)
    if return_lse:
        return out, lse.reshape(b, hq, sq)
    return out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True, window: Optional[int] = None,
                            q_offset: int = 0, q_chunk: int = 1024, kv_chunk: int = 1024,
                            scale: Optional[float] = None):
    """The attention backward, the arithmetic of the JAX package's
    `blocks._flash_backward`: p is recomputed per chunk pair from (q, k,
    lse), never stored whole.  q, out, dout (B, Sq, Hq, Dh), k, v (B, Skv,
    Hkv, Dh), lse (B, Hq, Sq) f32 as `flash_attention_ref` returns it.
    Returns (dq, dk, dv) in the inputs' dtypes.

    delta = Σ dout·out in f32; per pair p = exp(s − lse) (0 on masked
    entries, so a row that sees no key gets no gradient), dp = dout·vᵀ,
    ds = p (dp − delta); dq += (ds k)·scale, dv += pᵀ dout and dk += (dsᵀ
    q)·scale, dk and dv summed over the GQA group.  Every product takes
    its operands in the compute dtype (p and ds rounded to it first) and
    accumulates in f32.  The reference's two passes (dq per query chunk,
    then dk and dv per kv chunk) are one loop here: each accumulator
    still sums its chunk pairs in the reference's order (dq over kv chunks
    ascending, dk and dv over query chunks ascending), and p is computed
    once per pair instead of twice.  Pairs the mask hides are skipped."""
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    dev = q.device
    f32 = torch.float32

    def heads(t):             # (B, S, Hq, Dh) -> (B, Hkv, g, S, Dh) f32
        return t.to(f32).reshape(b, t.shape[1], hkv, g, dh).permute(0, 2, 3, 1, 4)

    qh, doh = heads(q), heads(dout)
    kh, vh = k.to(f32).permute(0, 2, 1, 3), v.to(f32).permute(0, 2, 1, 3)   # (B, Hkv, S, Dh)
    delta = (doh * heads(out)).sum(dim=-1)                                   # (B, Hkv, g, Sq)
    lse_h = lse.reshape(b, hkv, g, sq)
    dq = torch.zeros_like(qh)
    dk = torch.zeros_like(kh)
    dv = torch.zeros_like(vh)

    def rounded(t, dtype):    # t in `dtype`'s precision, kept in f32
        return t.to(dtype).to(f32)

    for q0, q1 in _chunks(sq, q_chunk):
        for k0, k1 in _chunks(skv, kv_chunk):
            mask = _visible(q0, q1, k0, k1, causal=causal, window=window, q_offset=q_offset,
                            device=dev)
            if mask is None:
                continue
            qb, dob = qh[:, :, :, q0:q1], doh[:, :, :, q0:q1]
            kb, vb = kh[:, :, k0:k1], vh[:, :, k0:k1]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb) * scale
            p = torch.where(mask, s.sub_(lse_h[..., q0:q1, None]).exp_(), 0.0)
            del s                 # each tile dies as soon as it is read
            dp = torch.einsum("bhgqd,bhkd->bhgqk", dob, vb)
            ds = dp.sub_(delta[..., q0:q1, None]).mul_(p)         # p (dp − delta), in dp
            dq[:, :, :, q0:q1] += torch.einsum("bhgqk,bhkd->bhgqd", rounded(ds, k.dtype),
                                               kb) * scale
            dv[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", rounded(p, dout.dtype), dob)
            dk[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", rounded(ds, q.dtype),
                                            qb) * scale
            del p, ds
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh).to(q.dtype)
    return dq, dk.permute(0, 2, 1, 3).to(k.dtype), dv.permute(0, 2, 1, 3).to(v.dtype)
