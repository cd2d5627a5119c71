"""Serving steps on one card: prefill + decode behind the bounded cache.

The port of the JAX package's `serve/serve_step.py`.  Both factories key
the serving engine's LRU (`BoundedCompileCache`) as the reference does, by
(step, config hash, mesh, params signature, batch or cache signature[,
cache size]), plus the `Execution` the step runs with.  PyTorch runs
eagerly, so there is nothing to jit: the cached value is the step callable
itself; only the DR engine's bucket programs are captured as CUDA graphs
(`serve/engine.py`).

Decode updates the cache it is given in place, as the reference donates
it.  One card has no mesh: `mesh` must be None until ROADMAP A10 brings
sharding.
"""

from __future__ import annotations

from typing import Any

from repro_torch.checkpoint import config_hash
from repro_torch.core.execution import Execution
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


def _check_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("sharded serving over a mesh is not ported yet "
                                  "(ROADMAP A10); pass mesh=None")


def make_prefill(cfg: ArchConfig, mesh, params_like: Any, batch_like: Any,
                 cache_size: int, *, cache: BoundedCompileCache = None,
                 execution: Execution = Execution()):
    """(params, batch) -> (last-position logits, kv cache).  `cache=None`
    uses the module-level LRU."""
    _check_mesh(mesh)
    key = ("prefill", config_hash(cfg), mesh, _tree_sig(params_like),
           _tree_sig(batch_like), cache_size, execution)

    def build():
        def fn(params, batch):
            return api.prefill(params, batch, cfg, cache_size, execution=execution)
        return fn

    return (cache if cache is not None else _CACHE).get_or_build(key, build)


def make_decode(cfg: ArchConfig, mesh, params_like: Any, cache_like: Any, *,
                cache: BoundedCompileCache = None, execution: Execution = Execution()):
    """(params, token, kv cache) -> (logits, kv cache), the cache updated
    in place."""
    _check_mesh(mesh)
    key = ("decode", config_hash(cfg), mesh, _tree_sig(params_like),
           _tree_sig(cache_like), execution)

    def build():
        def fn(params, token, kv_cache):
            return api.decode_step(params, token, kv_cache, cfg, execution=execution)
        return fn

    return (cache if cache is not None else _CACHE).get_or_build(key, build)
