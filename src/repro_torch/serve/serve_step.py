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

On a mesh (`repro_torch.launch.mesh`) params are laid out by
`param_specs`, the batch by `train_batch_specs` and the cache by
`cache_specs` (`repro_torch.dist.sharding.lay_out`; a batch or token may
also be the whole tensor every rank holds).  Each rank gathers the params,
runs the unmeshed model on its DP rows — attention's kernel on local
tensors — under `use_mesh`, so a MoE layer goes expert-parallel over
`model`, and hands back logits sharded over the DP axes and the cache in
its layout (the K/V sequence dim split over `model`).  Decode gathers each
cache leaf's `model` split, steps, and writes this rank's slice back in
place.
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

def _laid_out(t: torch.Tensor, spec, mesh, rows_dim: int):
    """A DTensor laid out by `spec` from `t`, which holds this rank's DP
    block of `rows_dim` and the whole of every other dim."""
    from torch.distributed.tensor import DTensor

    rest = tuple(None if i == rows_dim else ax for i, ax in enumerate(spec))
    loc = shard_rules.local_slice(t, rest, mesh)
    shape = list(t.shape)
    if spec[rows_dim] is not None:
        shape[rows_dim] *= shard_rules.axis_size(mesh, spec[rows_dim])
    return DTensor.from_local(loc if loc is t else loc.contiguous(), mesh,
                              shard_rules.placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape),
                              stride=shard_rules.contiguous_stride(shape))


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


def _global_specs(local_cache: Any, mesh, split: bool):
    """`cache_specs` of the global cache whose DP block `local_cache` is."""
    n = shard_rules.axis_size(mesh, shard_rules.batch_axes(mesh)) if split else 1
    like = tree_mod.tree_map(
        lambda t: _Shape((t.shape[0], t.shape[1] * n) + tuple(t.shape[2:]))
        if t.ndim >= 2 else _Shape(t.shape), local_cache)
    return shard_rules.cache_specs(like, mesh)


def _meshed_prefill(cfg: ArchConfig, mesh, cache_size: int, execution: Execution):
    dev = execution.torch_device()

    def fn(params, batch):
        split = shard_rules.splits_rows(_tree_sig(batch)[0][1][0], mesh)
        local_batch = {k: shard_rules.dp_rows(v, mesh, split).to(dev) for k, v in batch.items()}
        with shard_rules.use_mesh(mesh, rows_split=split):
            logits, cache = api.prefill(shard_rules.full_tree(params), local_batch, cfg,
                                        cache_size, execution=execution)
        specs = _global_specs(cache, mesh, split)
        cache = tree_mod.unflatten(cache, (
            _laid_out(t, specs[p], mesh, 1) if t.ndim >= 2 else t
            for p, t in tree_mod.flatten_with_path(cache)))
        lspec = ((shard_rules.batch_axes(mesh) if split else None), None)
        return _laid_out(logits, lspec, mesh, 0), cache

    return fn


def _meshed_decode(cfg: ArchConfig, mesh, execution: Execution):
    dev = execution.torch_device()
    keep = shard_rules.as_axes(shard_rules.batch_axes(mesh))

    def fn(params, token, kv_cache):
        flat = tree_mod.flatten_with_path(kv_cache)
        split = shard_rules.splits_rows(int(token.shape[0]), mesh)
        local_cache = tree_mod.unflatten(kv_cache, (
            shard_rules.gathered_except(t, keep) if shard_rules.is_dtensor(t) else t
            for _, t in flat))
        with shard_rules.use_mesh(mesh, rows_split=split):
            logits, new = api.decode_step(shard_rules.full_tree(params),
                                          shard_rules.dp_rows(token, mesh, split).to(dev),
                                          local_cache, cfg,
                                          execution=execution)
        out = []
        for (_, old), (_, val) in zip(flat, tree_mod.flatten_with_path(new)):
            if shard_rules.is_dtensor(old):
                rest = tuple(None if ax is not None and set(shard_rules.as_axes(ax)) <= set(keep)
                             else ax for ax in shard_rules.spec_of(old))
                loc, mine = old.to_local(), shard_rules.local_slice(val, rest, mesh)
                if not _same_memory(mine, loc):
                    loc.copy_(mine)
                out.append(old)
            else:
                out.append(val)
        lspec = ((shard_rules.batch_axes(mesh) if split else None), None)
        return _laid_out(logits, lspec, mesh, 0), tree_mod.unflatten(kv_cache, out)

    return fn

