"""Family-dispatched model API: one entry point for every assigned arch.

    init_params(gen, cfg, *, execution)                           -> param dict
    loss_fn(params, batch, cfg, *, remat, execution)              -> (loss, aux)  [train]
    prefill(params, batch, cfg, size, *, execution, kv_rp_r)      -> (logits, cache)
    decode_step(params, token, cache, cfg, *, execution, kv_rp_r) -> (logits, cache')
    init_cache(cfg, batch, size, *, execution)                    -> zero cache
    exact_param_counts(cfg)                                       -> (total, active)
    input_specs(cfg, shape_name, *, mode, device)                 -> fake inputs  [dry run]

`execution` is the port's `Execution`: its `device` ("cuda" unless the
caller asks for "cpu"; with no card the entry points raise) and its
`backend` ("kernel" routes attention's forward through the CUDA kernel).
The compute dtype is the config's `compute_dtype`, as in the reference.
Every family of the reference is ported: `transformer` with every option
(MoE, front-ends, `kv_rp`), `rwkv6` (its cache is the WKV decode state)
and `zamba` (SSD states beside the shared block's KV cache).  `kv_rp_r` is
an explicit key sketch for a transformer `kv_rp` config (the port draws its
own otherwise, `transformer.kv_rp_matrix`).  `loss_fn` is differentiable
with autograd: attention's backward is the plain chunked one
(`blocks.FlashAttentionFn`), the recurrences' are autograd through their
step loops, and with `remat` every layer runs under checkpoint.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

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


def loss_fn(params, batch, cfg: ArchConfig, *, remat: bool = True,
            execution: Execution = Execution()):
    """(loss, aux) of a training batch: `tokens` (B, S) integer, plus
    `frames` (B, S, f) for an audio config or `patches` (B, P, f) for a
    vision one (already reduced for a DR front-end config)."""
    return _mod(cfg).loss_fn(params, batch, cfg, remat=remat, execution=execution)


def splits_stream(cfg: ArchConfig, batch: Dict[str, Any], mesh) -> bool:
    """Whether a train or prefill batch's residual stream splits over
    "model" by sequence on `mesh` (`dist.sharding.seq_splits`): the
    transformer family only; the recurrent families keep it whole."""
    from repro_torch.dist import sharding

    return cfg.family == "transformer" and sharding.seq_splits(
        transformer.stream_len(cfg, batch), mesh)


def splits_features(cfg: ArchConfig, mesh) -> bool:
    """Whether a training step's carry splits over "model" by feature on
    `mesh`: Zamba-2's, where the ranks divide d_model (`ssm.splits`; the
    reference pins its carry's d over `model`, since its scan needs the
    whole sequence).  Each rank of `model` then holds its share of the
    loss, as with `splits_stream`."""
    from repro_torch.dist import sharding

    return cfg.family == "zamba" and ssm.splits(cfg, sharding.model_rank(mesh)[1])


def exact_param_counts(cfg: ArchConfig) -> Tuple[int, int]:
    """(total, active) parameter counts from the port's own init, run on
    fake (meta-backed) tensors, so no memory is allocated at any size.
    `active` discounts the stacked expert weights by top_k / E, the
    6·N_active·D convention for MoE model FLOPs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = _mod(cfg).init_params(torch.Generator(), cfg, device=torch.device("cpu"))
    flat = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], f"{path}[{k!r}]")
        else:
            flat.append((path, tree))

    walk(params, "")
    total = sum(t.numel() for _, t in flat)
    active = float(total)
    if cfg.moe is not None:
        for path, t in flat:
            if t.ndim == 4 and re.search(r"w_(in|gate|out)", path):
                active -= t.numel() * (1.0 - cfg.moe.top_k / cfg.moe.n_experts)
    return int(total), int(active)


def prefill(params, batch, cfg: ArchConfig, cache_size: int, *,
            execution: Execution = Execution(), kv_rp_r: Optional[torch.Tensor] = None):
    return _mod(cfg).prefill(params, batch, cfg, cache_size,
                             execution=execution, **_kv_rp_kw(cfg, kv_rp_r))


def decode_step(params, token, cache, cfg: ArchConfig, *,
                execution: Execution = Execution(), kv_rp_r: Optional[torch.Tensor] = None):
    return _mod(cfg).decode_step(params, token, cache, cfg,
                                 execution=execution, **_kv_rp_kw(cfg, kv_rp_r))


def cache_slots(cfg: ArchConfig, cache_size: int) -> Optional[int]:
    """The slots of a config's K/V cache at `cache_size` (None for `rwkv6`,
    whose state keeps no K/V cache)."""
    return None if cfg.family == "rwkv6" else transformer.cache_slots(cfg, cache_size)


def init_cache(cfg: ArchConfig, batch: int, cache_size: int, *,
               execution: Execution = Execution()) -> Dict[str, torch.Tensor]:
    """Zero cache, the structural twin of `prefill`'s (for `rwkv6` the
    decode state, whose size does not depend on `cache_size`)."""
    dev = execution.torch_device()
    if cfg.family == "rwkv6":
        return rwkv6.init_state(cfg, batch, dev)
    return _mod(cfg).init_cache(cfg, batch, cache_size, dev)


# ---------------------------------------------------------------------------
# assigned shape cells (the dry run's)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ArchConfig, shape_name: str) -> Tuple[bool, str]:
    """Assignment rules: encoder archs skip decode; long_500k needs
    sub-quadratic attention (SSM/hybrid/SWA)."""
    cell = SHAPES[shape_name]
    if not cfg.causal and cell.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape_name == "long_500k":
        subquad = cfg.family in ("rwkv6", "zamba") or cfg.sliding_window is not None
        if not subquad:
            return False, "pure full-attention arch; 500k cache excluded by assignment rule"
    return True, ""


def input_specs(cfg: ArchConfig, shape_name: str, *, batch_override: Optional[int] = None,
                seq_override: Optional[int] = None, mode=None, device="cuda") -> Dict[str, Any]:
    """Fake stand-ins for every model input of this cell: tensors of the
    cell's shapes and dtypes on `device` that hold no data, made under the
    `FakeTensorMode` `mode` (a new one when None), so nothing of model size
    is allocated and no card is needed.  Train and prefill cells get a
    batch dict (`tokens`, plus `frames` for an audio front-end or
    `patches` for a vision one); decode cells one token a sequence and the
    cache `init_cache(cfg, b, s)` makes.  `batch_override` / `seq_override`
    cut the cell's batch and length."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = mode if mode is not None else FakeTensorMode(allow_non_fake_inputs=True)
    cell = SHAPES[shape_name]
    b = batch_override or cell.global_batch
    s = seq_override or cell.seq_len
    dev = torch.device(device)
    with mode:
        if cell.kind in ("train", "prefill"):
            d: Dict[str, Any] = {"tokens": torch.empty((b, s), dtype=torch.int32, device=dev)}
            if cfg.frontend == "audio":
                d["frames"] = torch.empty((b, s, cfg.frontend_dim), dtype=torch.float32,
                                          device=dev)
            elif cfg.frontend == "vision":
                d["patches"] = torch.empty((b, cfg.frontend_seq, cfg.frontend_dim),
                                           dtype=torch.float32, device=dev)
            return {"batch": d}
        # decode: one new token against a seq_len-deep cache
        if cfg.family == "rwkv6":
            cache = rwkv6.init_state(cfg, b, dev)
        else:
            cache = _mod(cfg).init_cache(cfg, b, s, dev)
        return {"token": torch.empty((b,), dtype=torch.int32, device=dev), "cache": cache}
