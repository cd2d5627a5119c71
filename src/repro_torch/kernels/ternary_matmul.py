"""CUDA kernel: ternary random projection  y = scale · x Rᵀ.

Replaces the Pallas TPU kernel `src/repro/kernels/ternary_matmul.py`
(`ternary_matmul` / `_kernel`).  The kernel source is
`csrc/ternary_matmul.cu`; its header says what bounds it on the H100 and
what its design does about that.  In short: the C entry picks the body from
R's size (`plan`).  A small R (the paper's 24 × 32) takes a dense body, one
CTA per 32 × 32 output tile looping over the whole contraction.  A larger R
takes a sparse body that works in proportion to R's nonzeros, with
fused_transform's encoding (`csrc/ternary_encode.cuh`): per-call "nonzero" /
"negative" bit masks of R, and x added or subtracted where bits are set.
Either body is one launch, sums in f32 and rounds once to x's dtype.

For a CPU tensor the wrapper runs the plain version (`ref.ternary_matmul_ref`);
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ternary_matmul_ref

launches = 0   # kernel launches made by `ternary_matmul` in this process

plain = ternary_matmul_ref


def plan(b: int, m: int, p: int) -> int:
    """The body a call of x (b, m) and R (p, m) takes on the current device:
    0 for the dense body, else the sparse body's number of p tiles (one
    launch either way)."""
    out = ctypes.c_int(-1)
    _build.raise_on_error("ternary_matmul",
                          _build.library().repro_ternary_matmul_plan(b, m, p, out))
    return out.value


def ternary_matmul(x: torch.Tensor, r_int8: torch.Tensor, *,
                   scale: float = 1.0) -> torch.Tensor:
    """y (b, p) = scale * x @ r_int8ᵀ in x.dtype, f32 accumulation."""
    global launches
    if x.device.type == "cpu":
        return plain(x, r_int8, scale=scale)
    name = "ternary_matmul"
    _build.check_cuda(name, x, r_int8)
    if x.ndim != 2 or r_int8.ndim != 2 or x.shape[1] != r_int8.shape[1]:
        raise ValueError(f"{name}: want x (b, m) and r (p, m), got {tuple(x.shape)} "
                         f"and {tuple(r_int8.shape)}")
    if r_int8.dtype != torch.int8:
        raise TypeError(f"{name}: r must be int8, got {r_int8.dtype}")
    code = _build.dtype_code(name, x)
    b, m = x.shape
    p = r_int8.shape[0]
    out = torch.empty((b, p), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    rc = _build.library().repro_ternary_matmul(
        _build.ptr(x), _build.ptr(r_int8), _build.ptr(out), b, m, p, float(scale), code,
        _build.stream(x))
    _build.raise_on_error(name, rc)
    launches += 1
    return out
