"""CUDA kernel: fused serve transform  out = (scale · x Rᵀ) Bᵀ.

Replaces the Pallas TPU kernel `src/repro/kernels/fused_transform.py`
(`fused_transform` / `_kernel`).  The kernel source is
`csrc/fused_transform.cu`; its header says what bounds it on the H100 and
what its design does about that.  In short: one CTA per 32 rows × 64
output columns loops over p tiles, builds each y tile over the whole
contraction, keeps it in shared memory (the (b, p) intermediate never
reaches device memory) and adds y·Bᵀ into an f32 output tile that is
rounded to B's dtype once.

For a CPU tensor the wrapper runs the plain version (`ref.fused_transform_ref`);
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_transform_ref

launches = 0   # kernel launches made by `fused_transform` in this process

plain = fused_transform_ref


def fused_transform(x: torch.Tensor, r_int8: torch.Tensor, b_mat: torch.Tensor, *,
                    scale: float = 1.0) -> torch.Tensor:
    """out (b, n) = (scale * x @ r_int8ᵀ) @ b_matᵀ in b_mat.dtype, f32
    accumulation throughout."""
    global launches
    if x.device.type == "cpu":
        return plain(x, r_int8, b_mat, scale=scale)
    name = "fused_transform"
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
    rc = _build.library().repro_fused_transform(
        _build.ptr(x), _build.ptr(r_int8), _build.ptr(b_mat), _build.ptr(out),
        rows, m, p, n, float(scale), x_code, b_code, _build.stream(x))
    _build.raise_on_error(name, rc)
    launches += 1
    return out
