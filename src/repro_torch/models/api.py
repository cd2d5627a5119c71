"""Family-dispatched model API, the serving entry points:

    init_params(gen, cfg, *, execution)                           -> param dict
    prefill(params, batch, cfg, size, *, execution, kv_rp_r)      -> (logits, cache)
    decode_step(params, token, cache, cfg, *, execution, kv_rp_r) -> (logits, cache')
    init_cache(cfg, batch, size, *, execution)                    -> zero cache

`execution` is the port's `Execution`: its `device` ("cuda" unless the
caller asks for "cpu"; with no card the entry points raise) and its
`backend` ("kernel" routes attention's forward through the CUDA kernel).
The compute dtype is the config's `compute_dtype`, as in the reference.
`kv_rp_r` is an explicit key sketch for a `kv_rp` config (the port draws
its own otherwise, `transformer.kv_rp_matrix`).  The `transformer` family
is ported with every option (MoE, front-ends, `kv_rp`); `rwkv6` and
`zamba` raise `NotImplementedError` (ROADMAP A9e, A9f).  Training (`loss_fn` and the
backward) is not ported yet (ROADMAP A9g).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.execution import Execution
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig

_NOT_PORTED = {"rwkv6": "A9e", "zamba": "A9f"}


def _mod(cfg: ArchConfig):
    if cfg.family == "transformer":
        return transformer
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is not ported yet "
                                  f"(ROADMAP {_NOT_PORTED[cfg.family]})")
    raise ValueError(f"unknown model family {cfg.family!r}")


def init_params(gen: torch.Generator, cfg: ArchConfig, *,
                execution: Execution = Execution()) -> Dict[str, Any]:
    """Random params from `gen`, placed on the execution's device."""
    dev = execution.torch_device()
    return _mod(cfg).init_params(gen, cfg, device=dev)


def prefill(params, batch, cfg: ArchConfig, cache_size: int, *,
            execution: Execution = Execution(), kv_rp_r: Optional[torch.Tensor] = None):
    return _mod(cfg).prefill(params, batch, cfg, cache_size, execution=execution,
                             kv_rp_r=kv_rp_r)


def decode_step(params, token, cache, cfg: ArchConfig, *,
                execution: Execution = Execution(), kv_rp_r: Optional[torch.Tensor] = None):
    return _mod(cfg).decode_step(params, token, cache, cfg, execution=execution,
                                 kv_rp_r=kv_rp_r)


def init_cache(cfg: ArchConfig, batch: int, cache_size: int, *,
               execution: Execution = Execution()) -> Dict[str, torch.Tensor]:
    """Zero cache, the structural twin of `prefill`'s."""
    dev = execution.torch_device()
    return _mod(cfg).init_cache(cfg, batch, cache_size, dev)
