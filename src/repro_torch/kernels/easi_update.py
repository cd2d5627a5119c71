"""CUDA kernel: EASI relative gradient + weight update.

Replaces the Pallas TPU kernel `src/repro/kernels/easi_update.py`
(`easi_apply` / `_kernel`):

    G = (YᵀY/b − I)·so + (H − Hᵀ)·ho,   H = g(Y)ᵀY/b
    B ← B − μ G B

The kernel source is `csrc/easi_update.cu`; its header says what bounds it
on the H100 and what its design does about that.  In short: the C entry
picks the body (`plan`).  Where G is small (the paper's n = 16) one launch
does it all, as the TPU kernel does: each CTA builds G (f32, n × n) in
shared memory from the whole block, then updates its columns of B.  A
larger G takes two launches: the Gram products over (tiles of G) × (slices
of the samples), each tile's slices summed in order inside a thread block
cluster into f32 scratch this wrapper allocates, then B − μ G B tile by
tile.  `launches` counts the kernel launches made: 1 or 2 a call.

`block_m` is the reference's column tile (`Execution.easi_block_m`): the
columns of B one CTA updates.  Each body is compiled at three widths (the
small body 32, 64, 128; the split body's update 16, 32, 64), and `plan`
maps `block_m` onto them (`resource_model.effective_easi_tile`): a width
the body has runs, any other value its narrowest, then no wider than m
needs.  Every width gives the same bits.

For a CPU tensor the wrapper runs the plain version (`ref.easi_apply_ref`);
for a CUDA tensor it launches the kernel or raises.  A fake CUDA tensor (the
dry run, `kernels/fake.py`) takes a shape-only branch that launches nothing.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.kernels import _build, fake
from repro_torch.kernels.ref import easi_apply_ref

launches = 0   # kernel launches made by `easi_apply` in this process

plain = easi_apply_ref

G_KINDS = {"cubic": 0, "tanh": 1, "sign_cubic": 2}


def plan(b: int, n: int, m: int, second_order: bool = True, higher_order: bool = True,
         block_m: int = 512) -> tuple[int, int, int]:
    """The body a call with y (b, n) and B (n, m) takes on the current
    device, as (slices, scratch, cols): slices 0 for the one-launch small
    body, else the split body's number of sample slices (two launches);
    scratch, the f32 values of scratch the call needs; cols, the columns
    of B a CTA updates for `block_m`."""
    out = (ctypes.c_int * 3)(-1, -1, -1)
    _build.raise_on_error("easi_apply", _build.library().repro_easi_apply_plan(
        b, n, m, int(second_order), int(higher_order), int(block_m), out))
    return out[0], out[1], out[2]


def easi_apply(b_mat: torch.Tensor, y: torch.Tensor, *, mu: float,
               second_order: bool = True, higher_order: bool = True,
               g_name: str = "cubic", block_m: int = 512) -> torch.Tensor:
    """Returns the updated B (n, m) in b_mat.dtype; y (b, n) is the block of
    outputs the update is estimated from; `block_m` picks the column tile
    (`plan`)."""
    global launches
    if g_name not in G_KINDS:
        raise ValueError(f"unknown nonlinearity {g_name!r}")
    if b_mat.device.type == "cpu":
        return plain(b_mat, y, mu=mu, second_order=second_order,
                     higher_order=higher_order, g_name=g_name)
    name = "easi_apply"
    if fake.is_fake(b_mat):
        n, m = b_mat.shape
        bsz = y.shape[0]
        out = torch.empty_like(b_mat)
        grams = int(second_order) + int(higher_order)
        fake.report(name, 2.0 * bsz * n * n * grams + 2.0 * n * n * m,
                    fake.nbytes(y, b_mat, out))
        return out
    _build.check_cuda(name, b_mat, y)
    if b_mat.ndim != 2 or y.ndim != 2 or b_mat.shape[0] != y.shape[1]:
        raise ValueError(f"{name}: want b (n, m) and y (b, n), got {tuple(b_mat.shape)} "
                         f"and {tuple(y.shape)}")
    b_code, y_code = _build.dtype_code(name, b_mat), _build.dtype_code(name, y)
    n, m = b_mat.shape
    bsz = y.shape[0]
    if bsz == 0:
        raise ValueError(f"{name}: the block y holds no samples")
    out = torch.empty_like(b_mat)
    if out.numel() == 0:
        return out
    slices, n_scratch, cols = plan(bsz, n, m, second_order, higher_order, block_m)
    scratch = (torch.empty((n_scratch,), dtype=torch.float32, device=b_mat.device)
               if n_scratch else None)
    with obs.span("kernel.easi_apply"):
        rc = _build.library().repro_easi_apply(
            _build.ptr(y), _build.ptr(b_mat), None if scratch is None else _build.ptr(scratch),
            _build.ptr(out), bsz, n, m, float(mu), 1.0 / bsz, int(second_order),
            int(higher_order), G_KINDS[g_name], slices, cols, y_code, b_code,
            _build.stream(b_mat))
    _build.raise_on_error(name, rc)
    launches += 2 if slices else 1   # the Gram launch and the update, or the one small body
    return out
