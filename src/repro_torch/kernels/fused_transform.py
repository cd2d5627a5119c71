"""CUDA kernel: fused serve transform  out = (scale · x Rᵀ) Bᵀ.

Replaces the Pallas TPU kernel `src/repro/kernels/fused_transform.py`
(`fused_transform` / `_kernel`).  The kernel source is
`csrc/fused_transform.cu`; its header says what bounds it on the H100 and
what its design does about that.  In short: the C entry
`repro_fused_transform_tiles` picks the body from R's size.  A small R (the
paper's 24 × 32) takes a dense body, one CTA per 32 rows × 64 output
columns.  A larger R takes a sparse body that works in proportion to R's
nonzeros: each CTA takes 32 rows of x and a tile of rows of R, encodes
them as "nonzero" / "negative" bit masks (built with warp ballots, never
cached), adds or subtracts x's entries where the bits are set, in f32, and
multiplies the scaled y tile, held in shared memory, by B's matching slice.
When p is split over CTAs, they write f32 partials to a scratch buffer this
wrapper allocates, and a second launch sums them in p-tile order and rounds
once to B's dtype.  `launches` counts both launches.

The sparse body is templated over tile shapes (32 or 64 rows of x and at
most 16, 32 or 64 rows of R a CTA); `block_m` / `block_p` (an
`Execution`'s `tmm_block_m` / `tmm_block_p`) name one, clamped to the
templates and the problem by `resource_model.effective_tiles`; a size that
names no template runs 32 rows of x and at most 64 rows of R.  Each tile sums every output in
a fixed order, so it gives the same bits on every run; two tiles that split p
differently round differently in the last bits.

For a CPU tensor the wrapper runs the plain version (`ref.fused_transform_ref`);
for a CUDA tensor it launches the kernel or raises.  A fake CUDA tensor (the
dry run, `kernels/fake.py`) takes a shape-only branch that launches nothing.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.kernels import _build, fake
from repro_torch.kernels.ref import fused_transform_ref
from repro_torch.kernels.resource_model import effective_tiles

launches = 0   # kernel launches made by `fused_transform` in this process

plain = fused_transform_ref


def tiles(rows: int, m: int, p: int, block_m: int = 128, block_p: int = 128) -> int:
    """The body a call of x (rows, m) and R (p, m) takes on the current
    device: 0 for the dense body, else the sparse body's number of p tiles
    (more than one adds the summing launch)."""
    bm, bp = effective_tiles(rows, p, m, block_m, block_p)
    out = ctypes.c_int(-1)
    _build.raise_on_error("fused_transform",
                          _build.library().repro_fused_transform_tiles(rows, m, p, bm, bp, out))
    return out.value


def fused_transform(x: torch.Tensor, r_int8: torch.Tensor, b_mat: torch.Tensor, *,
                    scale: float = 1.0, block_m: int = 128,
                    block_p: int = 128) -> torch.Tensor:
    """out (b, n) = (scale * x @ r_int8ᵀ) @ b_matᵀ in b_mat.dtype, f32
    accumulation throughout."""
    global launches
    if x.device.type == "cpu":
        return plain(x, r_int8, b_mat, scale=scale)
    name = "fused_transform"
    if fake.is_fake(x):
        rows, m = x.shape
        n, p = b_mat.shape
        out = b_mat.new_empty((rows, n))
        fake.report(name, 2.0 * rows * m * p + 2.0 * rows * p * n,
                    fake.nbytes(x, r_int8, b_mat, out))
        return out
    _build.check_cuda(name, x, r_int8, b_mat)
    if (x.ndim != 2 or r_int8.ndim != 2 or b_mat.ndim != 2
            or x.shape[1] != r_int8.shape[1] or r_int8.shape[0] != b_mat.shape[1]):
        raise ValueError(f"{name}: want x (b, m), r (p, m) and b (n, p), got "
                         f"{tuple(x.shape)}, {tuple(r_int8.shape)} and {tuple(b_mat.shape)}")
    if r_int8.dtype != torch.int8:
        raise TypeError(f"{name}: r must be int8, got {r_int8.dtype}")
    x_code, b_code = _build.dtype_code(name, x), _build.dtype_code(name, b_mat)
    rows, m = x.shape
    n, p = b_mat.shape
    out = torch.empty((rows, n), dtype=b_mat.dtype, device=x.device)
    if out.numel() == 0:
        return out
    bm, bp = effective_tiles(rows, p, m, block_m, block_p)
    n_tiles = tiles(rows, m, p, bm, bp)
    part = (torch.empty((n_tiles, rows, n), dtype=torch.float32, device=x.device)
            if n_tiles > 1 else None)
    with obs.span("kernel.fused_transform"):
        rc = _build.library().repro_fused_transform(
            _build.ptr(x), _build.ptr(r_int8), _build.ptr(b_mat), _build.ptr(out),
            None if part is None else _build.ptr(part), rows, m, p, n, n_tiles, bm, bp,
            float(scale), x_code, b_code, _build.stream(x))
    _build.raise_on_error(name, rc)
    launches += 2 if n_tiles > 1 else 1   # the kernel, and the summing pass after it
    return out
