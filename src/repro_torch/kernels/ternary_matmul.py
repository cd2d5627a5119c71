"""CUDA kernel: ternary random projection  y = scale · x Rᵀ.

Replaces the Pallas TPU kernel `src/repro/kernels/ternary_matmul.py`
(`ternary_matmul` / `_kernel`).  The kernel source is
`csrc/ternary_matmul.cu`; its header says what bounds it on the H100 and
what its design does about that.  In short: one CTA per 32 × 32 output
tile loops over the whole contraction, R travels as int8 and is widened on
its way into shared memory, and the sum stays in f32 until one final
rounding to x's dtype.

For a CPU tensor the wrapper runs the plain version (`ref.ternary_matmul_ref`);
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ternary_matmul_ref

launches = 0   # kernel launches made by `ternary_matmul` in this process

plain = ternary_matmul_ref


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
