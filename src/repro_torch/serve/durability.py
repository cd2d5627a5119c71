"""Content addressing of model states: `host_state` and `state_hash`.

Only these two of the JAX package's `serve/durability.py` are ported so far
(ROADMAP A4d); the write-ahead log, the blob store and the snapshots follow
with the fleet (ROADMAP A8).  The engine uses `state_hash` to ask a
replicated registry whether it still holds a pushed state.

`state_hash` walks a state in the order and with the key strings of JAX's
`tree_flatten_with_path` over the reference's `ModelState`: `.stages[0]`,
`.stages[1]`, …, `.steps` (a stage state of None has no leaves), tuples and
lists by index, dicts by sorted key.  Each leaf contributes its key string,
its numpy dtype string (`bfloat16` included), `repr` of its shape (a
scalar's is `(1,)`, as `numpy.ascontiguousarray` leaves it) and its bytes,
so a port state and a reference state holding the same bytes hash the same.
"""

from __future__ import annotations

import hashlib
from typing import Any, Iterator, Tuple

import numpy as np
import torch

from repro_torch.dr.model import ModelState

PyTree = Any


def host_state(state: PyTree) -> PyTree:
    """Device → host copy of a state (CPU tensor leaves, never sharing
    memory with the source): what persistence and replication handle."""
    if state is None:
        return None
    if isinstance(state, ModelState):
        return ModelState(stages=host_state(state.stages), steps=host_state(state.steps),
                          trainable=state.trainable)
    if isinstance(state, (tuple, list)):
        return type(state)(host_state(s) for s in state)
    if isinstance(state, dict):
        return {k: host_state(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    return np.array(state, copy=True)


def state_hash(state: PyTree) -> str:
    """Content address of a state: key paths, dtypes, shapes, bytes.
    Stable across processes, and across torch and numpy leaves."""
    h = hashlib.sha256()
    for path, leaf in _leaves_with_path(state):
        dtype, a = _host_array(leaf)
        h.update(path.encode())
        h.update(dtype.encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _leaves_with_path(tree: PyTree, path: str = "") -> Iterator[Tuple[str, Any]]:
    if tree is None:
        return
    if isinstance(tree, ModelState):
        yield from _leaves_with_path(tree.stages, path + ".stages")
        yield from _leaves_with_path(tree.steps, path + ".steps")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def _host_array(leaf: Any) -> Tuple[str, np.ndarray]:
    """(numpy dtype string, host array holding the leaf's bytes), through
    `numpy.ascontiguousarray` as the reference does — which gives a scalar
    the shape (1,)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return "bfloat16", np.ascontiguousarray(t.view(torch.int16).numpy())
        a = np.ascontiguousarray(t.numpy())
        return str(a.dtype), a
    a = np.ascontiguousarray(np.asarray(leaf))
    return str(a.dtype), a
