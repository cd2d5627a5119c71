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

The sparse body is templated over tile shapes (32 or 64 rows of x and at
most 16, 32 or 64 rows of R a CTA); `block_m` / `block_p` (an
`Execution`'s `tmm_block_m` / `tmm_block_p`) name one, clamped to the
templates and the problem by `resource_model.effective_tiles`; a size that
names no template runs 32 rows of x and at most 64 rows of R.  Each tile sums every output in
a fixed order, so it gives the same bits on every run; two tiles may order
the sum differently (where R has words of many nonzeros) and differ in the
last bits.

For a CPU tensor the wrapper runs the plain version (`ref.ternary_matmul_ref`);
for a CUDA tensor it launches the kernel or raises.  A fake CUDA tensor (the
dry run, `kernels/fake.py`) takes a shape-only branch that launches nothing.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.kernels import _build, fake
from repro_torch.kernels.ref import ternary_matmul_ref
from repro_torch.kernels.resource_model import effective_tiles

launches = 0   # kernel launches made by `ternary_matmul` in this process

plain = ternary_matmul_ref


def plan(b: int, m: int, p: int, block_m: int = 128, block_p: int = 128) -> int:
    """The body a call of x (b, m) and R (p, m) takes on the current device:
    0 for the dense body, else the sparse body's number of p tiles (one
    launch either way)."""
    bm, bp = effective_tiles(b, p, m, block_m, block_p)
    out = ctypes.c_int(-1)
    _build.raise_on_error("ternary_matmul",
                          _build.library().repro_ternary_matmul_plan(b, m, p, bm, bp, out))
    return out.value


def ternary_matmul(x: torch.Tensor, r_int8: torch.Tensor, *, scale: float = 1.0,
                   block_m: int = 128, block_p: int = 128) -> torch.Tensor:
    """y (b, p) = scale * x @ r_int8ᵀ in x.dtype, f32 accumulation."""
    global launches
    if x.device.type == "cpu":
        return plain(x, r_int8, scale=scale)
    name = "ternary_matmul"
    if fake.is_fake(x):
        b, m = x.shape
        p = r_int8.shape[0]
        out = x.new_empty((b, p))
        fake.report(name, 2.0 * b * m * p, fake.nbytes(x, r_int8, out))
        return out
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
    bm, bp = effective_tiles(b, p, m, block_m, block_p)
    with obs.span("kernel.ternary_matmul"):
        rc = _build.library().repro_ternary_matmul(
            _build.ptr(x), _build.ptr(r_int8), _build.ptr(out), b, m, p, bm, bp, float(scale),
            code, _build.stream(x))
    _build.raise_on_error(name, rc)
    launches += 1
    return out
