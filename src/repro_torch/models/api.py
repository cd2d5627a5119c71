"""Family-dispatched model API, the serving entry points:

    init_params(gen, cfg, *, execution)                           -> param dict
    prefill(params, batch, cfg, size, *, execution, kv_rp_r)      -> (logits, cache)
    decode_step(params, token, cache, cfg, *, execution, kv_rp_r) -> (logits, cache')
    init_cache(cfg, batch, size, *, execution)                    -> zero cache

`execution` is the port's `Execution`: its `device` ("cuda" unless the
caller asks for "cpu"; with no card the entry points raise) and its
`backend` ("kernel" routes attention's forward through the CUDA kernel).
The compute dtype is the config's `compute_dtype`, as in the reference.
Every family of the reference is ported: `transformer` with every option
(MoE, front-ends, `kv_rp`), `rwkv6` (its cache is the WKV decode state)
and `zamba` (SSD states beside the shared block's KV cache).  `kv_rp_r` is
an explicit key sketch for a transformer `kv_rp` config (the port draws its
own otherwise, `transformer.kv_rp_matrix`).  Training (`loss_fn` and the
backward) is not ported yet (ROADMAP A9g).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.execution import Execution
from repro_torch.models import rwkv6, ssm, transformer
from repro_torch.models.config import ArchConfig


def _mod(cfg: ArchConfig):
    mods = {"transformer": transformer, "rwkv6": rwkv6, "zamba": ssm}
    if cfg.family not in mods:
        raise ValueError(f"unknown model family {cfg.family!r}")
    return mods[cfg.family]


def _kv_rp_kw(cfg: ArchConfig, kv_rp_r: Optional[torch.Tensor]) -> Dict[str, Any]:
    """The key sketch reaches the transformer only; the recurrent families
    keep no sketched keys."""
    if cfg.family == "transformer":
        return {"kv_rp_r": kv_rp_r}
    if kv_rp_r is not None:
        raise ValueError(f"{cfg.name}: kv_rp_r applies to the transformer family only")
    return {}


def init_params(gen: torch.Generator, cfg: ArchConfig, *,
                execution: Execution = Execution()) -> Dict[str, Any]:
    """Random params from `gen`, placed on the execution's device."""
    dev = execution.torch_device()
    return _mod(cfg).init_params(gen, cfg, device=dev)


def prefill(params, batch, cfg: ArchConfig, cache_size: int, *,
            execution: Execution = Execution(), kv_rp_r: Optional[torch.Tensor] = None):
    return _mod(cfg).prefill(params, batch, cfg, cache_size, execution=execution,
                             **_kv_rp_kw(cfg, kv_rp_r))


def decode_step(params, token, cache, cfg: ArchConfig, *,
                execution: Execution = Execution(), kv_rp_r: Optional[torch.Tensor] = None):
    return _mod(cfg).decode_step(params, token, cache, cfg, execution=execution,
                                 **_kv_rp_kw(cfg, kv_rp_r))


def init_cache(cfg: ArchConfig, batch: int, cache_size: int, *,
               execution: Execution = Execution()) -> Dict[str, torch.Tensor]:
    """Zero cache, the structural twin of `prefill`'s (for `rwkv6` the
    decode state, whose size does not depend on `cache_size`)."""
    dev = execution.torch_device()
    if cfg.family == "rwkv6":
        return rwkv6.init_state(cfg, batch, dev)
    return _mod(cfg).init_cache(cfg, batch, cache_size, dev)
