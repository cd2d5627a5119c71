"""The paper's downstream head: MLP with two hidden layers (§V-B, 64 units).

The JAX package's `models/mlp.py`, in PyTorch: parameters in the same
layout, `{"layers": [{"w": (d_in, d_out), "b": (d_out,)}, ...]}`, so
`repro_torch.bridge.params_from_reference` carries a JAX head across
unchanged.  Gradients come from `torch.autograd.grad`; the optimizer is the
port's AdamW (`repro_torch.train.optimizer`).  `train_epoch` is the
reference's jitted inner epoch, made public so a caller can feed it a
permutation of its own; `fit` draws one `randperm` per epoch from its
generator and calls it.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.execution import resolve_device
from repro_torch.train import optimizer as opt


def init(generator: torch.Generator, d_in: int, hidden: Sequence[int], n_classes: int, *,
         device="cuda") -> Dict:
    """He-normal weights drawn on the generator's device, zero biases; all
    placed on `device` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    dims = [d_in, *hidden, n_classes]
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=generator, dtype=torch.float32,
                        device=generator.device) * math.sqrt(2.0 / a)
        params.append({"w": w.to(dev), "b": torch.zeros((b,), dtype=torch.float32, device=dev)})
    return {"layers": params}


def apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    h = x
    layers = params["layers"]
    for i, lyr in enumerate(layers):
        h = h @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def loss_fn(params: Dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(apply(params, x), dim=-1)
    return -torch.mean(torch.gather(logp, -1, y.to(torch.int64)[:, None]))


def grad(params: Dict, x: torch.Tensor, y: torch.Tensor) -> Dict:
    """d loss_fn / d params, in the params' layout."""
    leaves = [p.detach().requires_grad_(True) for p in opt.tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(opt.tree_unflatten(params, leaves), x, y)
        grads = torch.autograd.grad(loss, leaves)
    return opt.tree_unflatten(params, grads)


def train_epoch(params: Dict, state: opt.OptState, x: torch.Tensor, y: torch.Tensor,
                perm: torch.Tensor, cfg: opt.AdamWConfig, *,
                batch: int = 128) -> Tuple[Dict, opt.OptState]:
    """One epoch over `perm`: max(1, n // batch) AdamW steps on consecutive
    `batch`-row slices of it; the tail that does not fill a batch is dropped."""
    steps_per_epoch = max(1, x.shape[0] // batch)
    idxs = perm[: steps_per_epoch * batch].reshape(steps_per_epoch, batch).to(x.device)
    for idx in idxs:
        g = grad(params, x[idx], y[idx])
        params, state, _ = opt.apply_updates(params, g, state, cfg)
    return params, state


def fit(
    params: Dict, x: torch.Tensor, y: torch.Tensor, *,
    lr: float = 5e-4, wd: float = 1e-2, epochs: int = 60, batch: int = 128,
    generator: torch.Generator,
) -> Dict:
    cfg = opt.AdamWConfig(lr=lr, grad_clip=None, weight_decay=wd)
    state = opt.init(params)
    n = x.shape[0]
    for _ in range(epochs):
        perm = torch.randperm(n, generator=generator, device=generator.device)
        params, state = train_epoch(params, state, x, y, perm, cfg, batch=batch)
    return params


def accuracy(params: Dict, x: torch.Tensor, y: torch.Tensor) -> float:
    return float(torch.mean((torch.argmax(apply(params, x), -1) == y).to(torch.float32)))
