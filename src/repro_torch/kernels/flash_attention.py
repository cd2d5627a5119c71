"""CUDA kernels: flash attention forward and backward (causal /
sliding-window / GQA).

The forward replaces the Pallas TPU kernel
`src/repro/kernels/flash_attention.py` (`flash_attention_fwd` / `_kernel`).
Its source is `csrc/flash_attention.cu`; its header says what bounds it on
the H100 and what its design does about that.  It holds two kernels, and the
C entry point picks one by dtype:

  - bf16 (the LM path): a tensor-core kernel, FA2-style.  Each CTA of 8
    warps owns a 128-row query tile (16 rows a warp, Q in registers, or
    at Dh 224 in shared memory; under GQA the rows of a group's heads
    share the CTA and its K/V tiles); K
    and V tiles stay bf16 in shared memory, double-buffered with cp.async;
    S = QKᵀ and P·V run on `mma.sync` m16n8k16 with f32 accumulation,
    p rounded to bf16 in registers; only tiles cut by a mask edge evaluate
    the mask.
  - f32: an FP32 FMA kernel (TF32 would not hold the f32 tolerance), one
    CTA per (batch, query head, 64-row query tile).

Both keep the online-softmax state (m, l, acc) on chip and loop over the kv
tiles the query tile can see.  Masked entries get p = 0, so a row that sees
no key returns 0 here and in the plain version (`ref.flash_attention_ref`);
every row that sees a key gets the reference's value.  With
`return_lse=True` both also write each row's log-sum-exp (B, Hq, Sq) in f32,
m + log(max(l, 1e-30)), the residual the attention backward
(`ref.flash_attention_bwd_ref`) recomputes p from; without it nothing is
written and the output is the same.

`flash_attention_bwd` is the backward, bf16 only (`csrc/flash_attention_bwd.cu`,
which replaces no TPU kernel: the reference's backward is XLA).  It takes the
forward's out and lse and returns (dq, dk, dv) in two launches: pass 1 sums
each row's delta = Σ dout·out and accumulates dq per query tile; pass 2
accumulates dk and dv per tile of 128 keys, summing the GQA group inside the
CTA.  p and ds are rounded to bf16 before each product, as the plain version
(`ref.flash_attention_bwd_ref`) rounds them; every sum has a fixed order, so
two calls give the same bits.

For a CPU tensor each wrapper runs its plain version; for a CUDA tensor it
launches the kernel for its dtype or raises.  A fake CUDA tensor (the dry
run, `kernels/fake.py`) takes a shape-only branch that launches nothing and
allocates what the kernel's outputs take, never the S × S scores of the plain
version.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.kernels import _build, fake
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

launches = 0       # kernel launches made by `flash_attention` in this process
bwd_launches = 0   # and by `flash_attention_bwd` (two a call)

plain = flash_attention_ref

MAX_DH = 224       # the widest head the bf16 kernel's tiles hold (Zamba2's shared block)
MAX_DH_F32 = 128   # and the f32 kernel's
MAX_DH_BWD = 128   # and the backward's


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, return_lse: bool = False,
                    scale: Optional[float] = None):
    """out (B, Sq, Hq, Dh) in q.dtype from q (B, Sq, Hq, Dh) and k, v
    (B, Skv, Hkv, Dh); query row r sits at position q_offset + r; the
    scores scaled by `scale` (default 1/√Dh).  With `return_lse`, (out,
    lse (B, Hq, Sq) f32).  The bf16 kernel takes Dh up to `MAX_DH`, the
    f32 one up to `MAX_DH_F32`."""
    global launches
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window, q_offset=q_offset,
                     return_lse=return_lse, scale=scale)
    name = "flash_attention"
    if fake.is_fake(q):
        b, sq, hq, dh = q.shape
        skv = k.shape[1]
        out = torch.empty_like(q)
        lse = q.new_empty((b, hq, sq), dtype=torch.float32) if return_lse else None
        pairs = fake.visible_pairs(sq, skv, causal, window, q_offset)
        fake.report(name, 4.0 * b * hq * dh * pairs, fake.nbytes(q, k, v, out, lse))
        return (out, lse) if return_lse else out
    _build.check_cuda(name, q, k, v)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: want q (B, Sq, Hq, Dh) and k, v (B, Skv, Hkv, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh or hq % hkv != 0:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match k/v {tuple(k.shape)} "
                         f"(same B and Dh, Hq a multiple of Hkv)")
    top = MAX_DH if q.dtype == torch.bfloat16 else MAX_DH_F32
    if dh > top:
        raise ValueError(f"{name}: head dim {dh} > {top} is not supported by the {q.dtype} "
                         f"kernel")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share a dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    code = _build.dtype_code(name, q)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    with obs.span("kernel.flash_attention"):
        rc = _build.library().repro_flash_attention(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            _build.ptr(lse) if return_lse else None, b, sq, skv, hq, hkv, dh,
            int(causal), -1 if window is None else int(window), int(q_offset),
            1.0 / math.sqrt(dh) if scale is None else float(scale), code, _build.stream(q))
    _build.raise_on_error(name, rc)
    launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        scale: Optional[float] = None):
    """(dq, dk, dv) in the inputs' dtype: the gradients of `flash_attention`
    at q (B, Sq, Hq, Dh), k, v (B, Skv, Hkv, Dh), from its out (B, Sq, Hq,
    Dh), its lse (B, Hq, Sq) f32 and the output's gradient dout (B, Sq, Hq,
    Dh)."""
    global bwd_launches
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window,
                                       q_offset=q_offset, scale=scale)
    name = "flash_attention_bwd"
    if fake.is_fake(q):
        b, sq, hq, dh = q.shape
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        pairs = fake.visible_pairs(sq, k.shape[1], causal, window, q_offset)
        # pass 1: s, dp, dq; pass 2: s, dp, dv, dk
        fake.report(name, 14.0 * b * hq * dh * pairs,
                    fake.nbytes(q, k, v, out, lse, dout, dq, dk, dv))
        return dq, dk, dv
    _build.check_cuda(name, q, k, v, out, lse, dout)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or out.shape != q.shape or \
            dout.shape != q.shape:
        raise ValueError(f"{name}: want q, out, dout (B, Sq, Hq, Dh) and k, v (B, Skv, Hkv, Dh), "
                         f"got {tuple(q.shape)}, {tuple(out.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh or hkv == 0 or hq % hkv != 0:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match k/v {tuple(k.shape)} "
                         f"(same B and Dh, Hq a multiple of Hkv)")
    if tuple(lse.shape) != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"{name}: want lse (B, Hq, Sq) = {(b, hq, sq)} float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if dh > MAX_DH_BWD:
        raise ValueError(f"{name}: head dim {dh} > {MAX_DH_BWD} is not supported by the kernel")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, out, dout)):
        raise TypeError(f"{name}: the kernel takes bfloat16 q, k, v, out and dout, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}, {out.dtype}, {dout.dtype}")
    if 0 in (b, sq, skv, hq, dh):
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    with obs.span("kernel.flash_attention_bwd"):
        rc = _build.library().repro_flash_attention_bwd(
            *map(_build.ptr, (q, k, v, out, dout, lse, delta, dq, dk, dv)), b, sq, skv, hq, hkv,
            dh, int(causal), -1 if window is None else int(window), int(q_offset),
            1.0 / math.sqrt(dh) if scale is None else float(scale), _build.stream(q))
    _build.raise_on_error(name, rc)
    bwd_launches += 2
    return dq, dk, dv
