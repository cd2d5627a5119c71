"""Optimizers over nested dicts / lists of tensors, and LR schedules.

The JAX package's `train/optimizer.py`, in PyTorch: AdamW with decoupled
weight decay, whose state holds an (m, v) pair of f32 tensors for each
parameter, in the parameters' own nesting.  `torch.optim.AdamW` is not a
substitute: its default b2 is 0.999 (here 0.95), it decays every tensor
(here only those of ndim >= 2 unless a mask says otherwise), and it orders
the update's arithmetic differently.

Leaves are visited in the reference's pytree order (dict keys sorted), so
the global norm sums in the same order.  `step` and the schedule live on
the host as 0-dim tensors: the device reads them as scalars.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    # Schedule: linear warmup -> cosine decay to lr*min_ratio over total_steps.
    warmup_steps: int = 0
    total_steps: int = 0          # 0 => constant lr after warmup
    min_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor   # int32, 0-dim, on the host
    m: Tree
    v: Tree


def tree_leaves(tree: Tree) -> List[Any]:
    """The leaves of nested dicts / lists / tuples, dict keys sorted (the
    order `jax.tree.leaves` gives)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def _fill(t: Tree, it) -> Tree:
    if isinstance(t, dict):
        return {k: _fill(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_fill(u, it) for u in t)
    return next(it)


def tree_unflatten(like: Tree, leaves) -> Tree:
    """`like`'s nesting filled from the iterable `leaves`, in `tree_leaves`
    order.  The recursion is a module function: a nested function that
    calls itself is a reference cycle, which would keep `leaves` (a step's
    whole gradient) alive until Python's cyclic collector runs."""
    return _fill(like, iter(leaves))


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """`fn` over the leaves of `tree` and the matching leaves of `rest`,
    in `tree`'s nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def init(params: Tree) -> OptState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return OptState(step=torch.zeros((), dtype=torch.int32), m=zeros,
                    v=tree_map(torch.clone, zeros))


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    s = torch.as_tensor(step).to(torch.float32)
    lr = torch.tensor(cfg.lr, dtype=torch.float32)
    if cfg.warmup_steps > 0:
        warm = torch.clamp((s + 1.0) / cfg.warmup_steps, max=1.0)
    else:
        warm = 1.0
    if cfg.total_steps > 0:
        t = torch.clamp((s - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
                        0.0, 1.0)
        cos = cfg.min_ratio + (1.0 - cfg.min_ratio) * 0.5 * (
            1.0 + torch.cos(torch.tensor(math.pi, dtype=torch.float32) * t))
    else:
        cos = 1.0
    return lr * warm * cos


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32))) for l in leaves))


def clip_by_global_norm(grads: Tree, max_norm: float, *, norm: Optional[torch.Tensor] = None
                        ) -> Tuple[Tree, torch.Tensor]:
    """`grads` scaled to a global norm of at most `max_norm`, and the norm
    (`norm` if given: a norm over shards that `global_norm` cannot see)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def apply_updates(
    params: Tree, grads: Tree, state: OptState, cfg: AdamWConfig,
    *, decay_mask: Optional[Tree] = None,
) -> Tuple[Tree, OptState, dict]:
    """AdamW step. decay_mask: the params' nesting of bools — True => apply
    weight decay; by default every tensor of ndim >= 2 (not norms, biases)."""
    if cfg.grad_clip is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = schedule(cfg, state.step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** step.to(torch.float32)
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** step.to(torch.float32)

    def upd(p, g, m, v, decay):
        g32 = g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * torch.square(g32)
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        p32 = p.to(torch.float32)
        if cfg.weight_decay:
            delta = delta + (cfg.weight_decay if bool(decay) else 0.0) * p32
        return (p32 - lr * delta).to(p.dtype), m_new, v_new

    if decay_mask is None:
        decay_mask = tree_map(lambda p: p.ndim >= 2, params)

    flat = zip(*(tree_leaves(t) for t in (params, grads, state.m, state.v, decay_mask)))
    out = [upd(*leaves) for leaves in flat]
    new_p, new_m, new_v = (tree_unflatten(params, (o[i] for o in out)) for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, OptState(step=step, m=new_m, v=new_v), metrics
