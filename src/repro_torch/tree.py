"""Trees of tensors in the JAX package's pytree order.

One walker for every nested state the port handles: a `ModelState`
(`.stages`, then `.steps`), a NamedTuple (its fields by name), a dict (keys
sorted), a list or tuple (by index); `None` holds no leaf and anything else
is a leaf.  That is the order of JAX's `tree_flatten_with_path` over the
reference's twins, and each path is the string `jax.tree_util.keystr`
gives it (`.stages[1]`, `.params['wq']`), so content hashes, checkpoint
manifests and the fleet merge's per-leaf R keys line up across packages.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Tuple

from repro_torch.dr.model import ModelState

Tree = Any


def _is_namedtuple(t: Any) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _walk(tree: Tree, path: str) -> Iterator[Tuple[str, Any]]:
    if tree is None:
        return
    if isinstance(tree, ModelState):
        yield from _walk(tree.stages, path + ".stages")
        yield from _walk(tree.steps, path + ".steps")
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _walk(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}[{i}]")
    else:
        yield path, tree


def flatten_with_path(tree: Tree) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in pytree order."""
    return list(_walk(tree, ""))


def leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in _walk(tree, "")]


def unflatten(like: Tree, new_leaves: Iterable[Any]) -> Tree:
    """`like`'s nesting with its leaves replaced, in order, from `new_leaves`."""
    it = iter(new_leaves)

    def go(t):
        if t is None:
            return None
        if isinstance(t, ModelState):
            stages = go(t.stages)
            return ModelState(stages=stages, steps=go(t.steps), trainable=t.trainable)
        if _is_namedtuple(t):
            return type(t)(*(go(getattr(t, n)) for n in t._fields))
        if isinstance(t, dict):
            out = {k: go(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(go(u) for u in t)
        return next(it)

    out = go(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """`fn` over the leaves of `tree` and the matching leaves of `rest` (trees
    of the same structure), in `tree`'s nesting."""
    flat = [leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("tree_map over trees with different numbers of leaves")
    return unflatten(tree, (fn(*xs) for xs in zip(*flat)))
