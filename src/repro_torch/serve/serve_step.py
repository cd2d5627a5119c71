"""Serving steps: prefill + decode behind the bounded cache, with or
without a mesh.

The port of the JAX package's `serve/serve_step.py`.  Both factories key
the serving engine's LRU (`BoundedCompileCache`) as the reference does, by
(step, config hash, mesh, params signature, batch or cache signature[,
cache size]), plus the `Execution` the step runs with.  PyTorch runs
eagerly, so there is nothing to jit: the cached value is the step callable
itself; only the DR engine's bucket programs are captured as CUDA graphs
(`serve/engine.py`).

Decode updates the cache it is given in place, as the reference donates
it.

On a mesh (`repro_torch.launch.mesh`) params are laid out by `param_specs`,
the batch by `train_batch_specs` and the cache by `cache_specs`
(`repro_torch.dist.sharding.lay_out`; a batch or token may also be the whole
tensor every rank holds).  Each rank computes on the shards it stores: the
model code runs on its DP rows, under `use_mesh` for the K/V cache's slot
split, with the params of `dist.sharding.compute_params` (each layer read
inside its loop, the rest once a step; with several `model` ranks the
layers split over them — a transformer's prefill stream by sequence where
their count divides it, `api.splits_stream`, the dense products and heads
tensor-parallel; the recurrent families' products by SSD or WKV head on a
whole stream, their states gathered into the replicated cache — and a MoE
layer goes expert-parallel over `model` on the stored expert shards) and — attention's kernel on local tensors — hands back
logits sharded over the DP axes and the cache in its layout.  The K/V
cache's slots stay split over `model`: prefill writes each rank's slot
range, decode writes the new key on the rank that owns its slot and merges
the ranks' attention through the log-sum-exp, updating the cache's local
shards in place.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as tree_mod
from repro_torch.checkpoint import config_hash
from repro_torch.core.execution import Execution
from repro_torch.dist import sharding as shard_rules
from repro_torch.models import api
from repro_torch.models.config import ArchConfig
from repro_torch.serve.batching import BoundedCompileCache

_CACHE = BoundedCompileCache(maxsize=32)


def _tree_sig(tree: Any, path: str = ""):
    """Hashable (path, shape, dtype) signature of a nested dict / list of
    tensors (or of anything with `.shape` and `.dtype`); paths are spelled
    as JAX's keystr spells them (`['layers']['wq']`)."""
    if isinstance(tree, dict):
        return tuple(e for k in sorted(tree) for e in _tree_sig(tree[k], f"{path}[{k!r}]"))
    if isinstance(tree, (list, tuple)):
        return tuple(e for i, t in enumerate(tree) for e in _tree_sig(t, f"{path}[{i}]"))
    return ((path, tuple(tree.shape), str(tree.dtype)),)


def make_prefill(cfg: ArchConfig, mesh, params_like: Any, batch_like: Any,
                 cache_size: int, *, cache: BoundedCompileCache = None,
                 execution: Execution = Execution()):
    """(params, batch) -> (last-position logits, kv cache).  `cache=None`
    uses the module-level LRU."""
    shard_rules.check_mesh(mesh)
    key = ("prefill", config_hash(cfg), mesh, _tree_sig(params_like),
           _tree_sig(batch_like), cache_size, execution)

    def build():
        if mesh is not None:
            return _meshed_prefill(cfg, mesh, cache_size, execution)

        def fn(params, batch):
            return api.prefill(params, batch, cfg, cache_size, execution=execution)
        return fn

    return (cache if cache is not None else _CACHE).get_or_build(key, build)


def make_decode(cfg: ArchConfig, mesh, params_like: Any, cache_like: Any, *,
                cache: BoundedCompileCache = None, execution: Execution = Execution()):
    """(params, token, kv cache) -> (logits, kv cache), the cache updated
    in place."""
    shard_rules.check_mesh(mesh)
    key = ("decode", config_hash(cfg), mesh, _tree_sig(params_like),
           _tree_sig(cache_like), execution)

    def build():
        if mesh is not None:
            return _meshed_decode(cfg, mesh, execution)

        def fn(params, token, kv_cache):
            return api.decode_step(params, token, kv_cache, cfg, execution=execution)
        return fn

    return (cache if cache is not None else _CACHE).get_or_build(key, build)


# ---------------------------------------------------------------------------
# the meshed steps
# ---------------------------------------------------------------------------

def _laid_out(t: torch.Tensor, spec, mesh):
    """A DTensor laid out by `spec` from `t`, this rank's shard of it."""
    from torch.distributed.tensor import DTensor

    shape = [n * shard_rules.axis_size(mesh, ax) for n, ax in zip(t.shape, spec)]
    return DTensor.from_local(t, mesh, shard_rules.placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape), stride=shard_rules.contiguous_stride(shape))


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether `a` and `b` start at one place of one storage, read without
    `data_ptr`, which the dry run's fake tensors do not have."""
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset())


class _Shape:
    """A leaf with a shape and nothing else, for the rules that read shapes."""

    def __init__(self, shape):
        self.shape = torch.Size(shape)
        self.ndim = len(self.shape)


def _global_specs(local_cache: Any, mesh, split: bool, kv_split: bool):
    """`cache_specs` of the global cache whose shard `local_cache` is: its
    DP block of the batch when `split`, its block of the K/V slots over
    "model" when `kv_split`."""
    n_dp = shard_rules.axis_size(mesh, shard_rules.batch_axes(mesh)) if split else 1
    n_kv = shard_rules.axis_size(mesh, "model") if kv_split else 1

    def whole(path, t):
        if t.ndim < 2:
            return _Shape(t.shape)
        shape = [t.shape[0], t.shape[1] * n_dp] + list(t.shape[2:])
        if shard_rules.is_kv_leaf(path, t):
            shape[2] *= n_kv
        return _Shape(shape)

    flat = tree_mod.flatten_with_path(local_cache)
    return shard_rules.cache_specs(tree_mod.unflatten(local_cache, (whole(p, t) for p, t in flat)),
                                   mesh)


def _on_shards(params, mesh, split: bool, seq: bool = False):
    local, specs = shard_rules.local_specs(params)
    return shard_rules.compute_params(local, specs, mesh, split, seq, lazy=True)


def _meshed_prefill(cfg: ArchConfig, mesh, cache_size: int, execution: Execution):
    dev = execution.torch_device()
    slots = api.cache_slots(cfg, cache_size)
    kv_split = slots is not None and shard_rules.kv_splits(slots, mesh)

    def fn(params, batch):
        split = shard_rules.splits_rows(_tree_sig(batch)[0][1][0], mesh)
        local_batch = {k: shard_rules.dp_rows(v, mesh, split).to(dev) for k, v in batch.items()}
        seq = api.splits_stream(cfg, local_batch, mesh)
        with shard_rules.use_mesh(mesh, kv_split=kv_split):
            logits, cache = api.prefill(_on_shards(params, mesh, split, seq), local_batch,
                                        cfg, cache_size, execution=execution)
        specs = _global_specs(cache, mesh, split, kv_split)
        cache = tree_mod.unflatten(cache, (
            _laid_out(t, specs[p], mesh) if t.ndim >= 2 else t
            for p, t in tree_mod.flatten_with_path(cache)))
        lspec = ((shard_rules.batch_axes(mesh) if split else None), None)
        return _laid_out(logits, lspec, mesh), cache

    return fn


def _meshed_decode(cfg: ArchConfig, mesh, execution: Execution):
    dev = execution.torch_device()

    def fn(params, token, kv_cache):
        flat = tree_mod.flatten_with_path(kv_cache)
        split = shard_rules.splits_rows(int(token.shape[0]), mesh)
        kv_split = any(shard_rules.is_dtensor(t) and shard_rules.is_kv_leaf(p, t)
                       and "model" in shard_rules.as_axes(shard_rules.spec_of(t)[2])
                       for p, t in flat)
        local_cache = tree_mod.unflatten(kv_cache, (shard_rules.local(t) for _, t in flat))
        with shard_rules.use_mesh(mesh, kv_split=kv_split):
            logits, new = api.decode_step(_on_shards(params, mesh, split),
                                          shard_rules.dp_rows(token, mesh, split).to(dev),
                                          local_cache, cfg, execution=execution)
        out = []
        for (_, old), (_, val) in zip(flat, tree_mod.flatten_with_path(new)):
            if shard_rules.is_dtensor(old):
                loc = old.to_local()
                if not _same_memory(val, loc):
                    loc.copy_(val)
                out.append(old)
            else:
                out.append(val)
        lspec = ((shard_rules.batch_axes(mesh) if split else None), None)
        return _laid_out(logits, lspec, mesh), tree_mod.unflatten(kv_cache, out)

    return fn
