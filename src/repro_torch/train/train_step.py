"""The single-device train step: loss → autograd → AdamW, remat,
grad-accumulation, and the DR front-end co-trained inside the step.

The JAX package's `train/train_step.py` without its mesh.  `make_train_step`
returns a callable `(state, batch) -> (state, metrics)`: the loss
(`api.loss_fn`, each layer under checkpoint with `remat`) and its
gradients by autograd, `optimizer.apply_updates`, then, for a
`dr_frontend` config, one streaming EASI update of the DR unit
(`dr_unit.update`) on the first 4096 normalised raw rows of the batch.
The DR unit is trained by EASI, not by the optimizer: the loss reads it
through `_apply_dr_frontend` with no gradient.  Every call takes the
caller's `Execution`, so with `backend="kernel"` attention's forward runs
the flash kernel, the front-end's transform the fused-transform kernel and
the DR update the ternary-matmul and EASI kernels.

The reference's mesh path (`make_train_step`'s shardings) and its
RP-compressed data-parallel step (`make_dp_compressed_step`) need several
cards (ROADMAP A10, A8): `make_train_step` raises for a mesh or a
`grad_compress`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import dr_unit
from repro_torch.core.execution import Execution
from repro_torch.models import api
from repro_torch.models.config import ArchConfig
from repro_torch.train import optimizer as opt_mod

Tree = Any
DR_UPDATE_ROWS = 4096   # the bounded block of raw rows each step folds into the DR unit


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    arch: ArchConfig
    opt: opt_mod.AdamWConfig = opt_mod.AdamWConfig()
    remat: bool = True
    grad_accum: int = 1
    grad_compress: Optional[Any] = None   # the reference's CompressConfig (ROADMAP A8)
    seed: int = 0


class TrainState(NamedTuple):
    params: Tree
    opt: opt_mod.OptState
    dr: Optional[dr_unit.DRState]    # DR front-end (EASI-trained, not SGD)
    step: torch.Tensor               # int32, 0-dim, on the host


def _dr_cfg(arch: ArchConfig) -> Optional[dr_unit.DRConfig]:
    spec = arch.dr_frontend
    if spec is None:
        return None
    return dr_unit.DRConfig(
        kind=spec.kind, m=arch.frontend_dim, p=spec.p, n=spec.n,
        mu=spec.mu, block_size=1, bypass_whitening=spec.bypass_whitening)


def init_state(gen: torch.Generator, cfg: TrainConfig, *,
               execution: Execution = Execution()) -> TrainState:
    """Params, then the DR unit's state, drawn from `gen`, on the
    execution's device; AdamW moments at zero."""
    params = api.init_params(gen, cfg.arch, execution=execution)
    dcfg = _dr_cfg(cfg.arch)
    dr = dr_unit.init(gen, dcfg, execution=execution) if dcfg is not None else None
    return TrainState(params=params, opt=opt_mod.init(params), dr=dr,
                      step=torch.zeros((), dtype=torch.int32))


def _dr_normalize(flat: torch.Tensor) -> torch.Tensor:
    """Centre + one global scalar scale (the pipeline's DR-stage convention);
    keeps the cubic EASI update in its stable regime for any feature scale."""
    mean = torch.mean(flat, dim=0)
    scale = torch.sqrt(torch.mean(torch.var(flat - mean, dim=0, unbiased=False))) + 1e-8
    return (flat - mean) / scale


def _apply_dr_frontend(state_dr: Optional[dr_unit.DRState], dcfg: dr_unit.DRConfig,
                       batch: Dict[str, torch.Tensor], *,
                       execution: Optional[Execution] = None) -> Dict[str, torch.Tensor]:
    """The batch with its frames (or patches) (B, S, f) replaced by their
    reduced features (B, S, n); the batch as given without a DR state.  The
    DR state carries no gradient (the reference's stop-gradient)."""
    if state_dr is None:
        return batch
    key = "frames" if "frames" in batch else "patches"
    feats = batch[key]
    b, s, fd = feats.shape
    flat = _dr_normalize(feats.reshape(b * s, fd))
    red = dr_unit.transform(state_dr, dcfg, flat, execution=execution)
    return {**batch, key: red.reshape(b, s, -1)}


def make_loss(cfg: TrainConfig, dcfg: Optional[dr_unit.DRConfig], *,
              execution: Execution = Execution()):
    """loss(params, dr, batch) -> (loss, aux): the DR front-end, then
    `api.loss_fn`."""
    def loss(params, dr, batch):
        batch = _apply_dr_frontend(dr, dcfg, batch, execution=execution)
        return api.loss_fn(params, batch, cfg.arch, remat=cfg.remat, execution=execution)
    return loss


def value_and_grad(loss_fn, params: Tree, dr, batch) -> Tuple[torch.Tensor, dict, Tree]:
    """(loss, aux, grads in params' nesting) by autograd; a leaf the loss
    does not read gets a zero gradient, as `jax.grad` gives it."""
    leaves = [t.detach().requires_grad_(True) for t in opt_mod.tree_leaves(params)]
    loss, aux = loss_fn(opt_mod.tree_unflatten(params, leaves), dr, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            opt_mod.tree_unflatten(params, grads))


def make_train_step(cfg: TrainConfig, *, execution: Execution = Execution(), mesh=None):
    """Returns `step(state, batch) -> (state, metrics)` on the execution's
    device; `batch` holds CPU or device tensors (`tokens`, and `frames` or
    `patches` for a front-end config).  With `grad_accum` = k > 1 the batch
    is split into k micro-batches along its first axis: their gradients are
    summed and divided by k, the loss averaged, the aux terms dropped, as
    the reference's scan does.  `metrics` holds `loss`, `grad_norm`, `lr`
    and the loss's aux terms."""
    if mesh is not None:
        raise NotImplementedError("the meshed train step (shardings over several cards) is "
                                  "not ported yet (ROADMAP A10)")
    if cfg.grad_compress is not None:
        raise NotImplementedError("the RP-compressed data-parallel step is not ported yet "
                                  "(ROADMAP A8)")
    dev = execution.torch_device()
    dcfg = _dr_cfg(cfg.arch)
    loss_fn = make_loss(cfg, dcfg, execution=execution)
    k = cfg.grad_accum

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        batch = {name: torch.as_tensor(t).to(dev) for name, t in batch.items()
                 if name != "step"}
        if k > 1:
            gsum, lsum = None, 0.0
            for i in range(k):
                micro = {name: t.reshape((k, t.shape[0] // k) + t.shape[1:])[i]
                         for name, t in batch.items()}
                loss, _, g = value_and_grad(loss_fn, state.params, state.dr, micro)
                gsum = g if gsum is None else opt_mod.tree_map(torch.add, gsum, g)
                lsum = lsum + loss
            grads = opt_mod.tree_map(lambda t: t / k, gsum)
            loss, aux = lsum / k, {}
        else:
            loss, aux, grads = value_and_grad(loss_fn, state.params, state.dr, batch)
        with torch.no_grad():
            params, opt_state, metrics = opt_mod.apply_updates(state.params, grads, state.opt,
                                                               cfg.opt)
            del grads
            # DR front-end: streaming EASI update on this batch's raw features
            dr = state.dr
            if dr is not None:
                key = "frames" if "frames" in batch else "patches"
                feats = _dr_normalize(batch[key].reshape(-1, cfg.arch.frontend_dim))
                dr = dr_unit.update(dr, dcfg, feats[:DR_UPDATE_ROWS], execution=execution)
        new_state = TrainState(params=params, opt=opt_state, dr=dr, step=state.step + 1)
        return new_state, {"loss": loss, **metrics, **aux}

    return step
