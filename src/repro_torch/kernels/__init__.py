"""Hand-written CUDA kernels (sm_90a) for the DR datapath's and the LM's hot
spots:

  ternary_matmul  — int8 ternary RP product  scale · x Rᵀ
  fused_transform — fused project + whiten serve transform (scale·xRᵀ)Bᵀ
  easi_update     — EASI relative gradient + weight update (easi_apply)
  flash_attention — online-softmax attention forward (causal / SWA / GQA)
                    and its backward (dq, dk, dv in two passes)
  ops             — the entry points the DR and LM layers call
  ref             — plain PyTorch versions (the CPU path and the ground truth)
  autotune        — the serving engine's per-bucket tile race
  resource_model  — each kernel body's threads, shared bytes, registers and
                    occupancy on the H100, and the tile templates
  fake            — the wrappers' shape-only branch for the dry run's fake tensors

Sources live in `csrc/`; `_build` compiles them with nvcc at first use and
loads them through ctypes.  Importing this package builds nothing.
"""

from typing import Dict

from repro_torch.kernels import (autotune, easi_update, flash_attention, fused_transform, ops,
                                 ref, ternary_matmul)

__all__ = ["autotune", "easi_update", "flash_attention", "fused_transform", "launch_counts",
           "ops", "ref", "ternary_matmul"]


def launch_counts() -> Dict[str, int]:
    """The kernel launches each wrapper has made in this process (its
    module-level `launches`)."""
    return {"ternary_matmul": ternary_matmul.launches,
            "fused_transform": fused_transform.launches,
            "easi_apply": easi_update.launches,
            "flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention.bwd_launches}
