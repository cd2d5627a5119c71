"""Execution policy: which backend runs the DR datapath and the LM's
attention, and on which device.

One frozen object, resolved once when a `repro_torch.dr.DRModel` is built,
or passed to each LM entry point (`repro_torch.models.api`):

    backend="torch"   — plain PyTorch ops (reference semantics everywhere)
    backend="kernel"  — the hand-written CUDA kernels (`repro_torch.kernels`)
                        for CUDA tensors; their plain versions for CPU tensors

`device` defaults to "cuda": an entry point runs on the card unless the
caller asks for the CPU (`device="cpu"`, as the tests do).  With no card
and no explicit "cpu", `resolve_device` raises; nothing drops to the CPU
quietly.

The tile fields mirror the JAX policy's and are kept for the autotuner
(not ported yet); the present CUDA kernels use the fixed tiles set in their
sources.  `dtype` is the compute dtype stages inherit unless they pin their
own.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

BACKENDS = ("torch", "kernel")


@dataclasses.dataclass(frozen=True)
class Execution:
    backend: str = "torch"
    # ternary-matmul (RP) kernel tiles: rows × output dims × contraction
    tmm_block_m: int = 128
    tmm_block_p: int = 128
    tmm_block_k: int = 512
    # EASI-update kernel: sample-block tile
    easi_block_m: int = 512
    dtype: Any = torch.float32
    device: Any = "cuda"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; one of {BACKENDS}")
        for f in ("tmm_block_m", "tmm_block_p", "tmm_block_k", "easi_block_m"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1")
        if torch.device(self.device).type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device!r}; 'cuda' or 'cpu'")

    @property
    def use_kernel(self) -> bool:
        return self.backend == "kernel"

    def torch_device(self) -> torch.device:
        return resolve_device(self.device)


def resolve_device(device: Any) -> torch.device:
    """The torch device an entry point runs on; raises for a CUDA device
    when no card is present (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        # The f32 tolerances (1e-5) do not survive TF32, so every f32
        # matmul on the card runs in full IEEE f32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return dev


TORCH = Execution(backend="torch")
KERNEL = Execution(backend="kernel")


def resolve(execution: Execution | None = None, use_kernel: bool = False) -> Execution:
    """Back-compat shim: an explicit Execution wins; else map the legacy
    `use_kernel` flag onto the default policy for that backend (both on the
    card)."""
    if execution is not None:
        return execution
    return KERNEL if use_kernel else TORCH
