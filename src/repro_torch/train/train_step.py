"""The train step: loss → autograd → AdamW, remat, grad-accumulation,
the DR front-end co-trained inside the step, on one card or a mesh, and
the data-parallel step with the RP-compressed gradient sync.

The JAX package's `train/train_step.py`.  `make_train_step`
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

On a mesh (`make_train_step(..., mesh=)`) the state is stored as
`state_specs` lays it out — params and AdamW m / v sharded by
`param_specs`, as DTensors (`dist.sharding.lay_out`); the DR unit and the
counters replicated — and the batch shards over the DP axes.  The step
computes on the shards it stores (`dist.sharding.compute_params`): each
layer body gathers that layer's params inside its checkpointed body, so
the backward gathers them again and no whole layer lives from forward to
backward; the embedding, head, norms, a shared block and the front-end
projections are gathered once a step; the gathers' backward reduce-scatters
each gradient to this rank's shard and averages it over the DP axes, so no
rank holds a whole gradient.  Micro-batch sums, the global norm (each
leaf's squares summed over the axes it is split on), clipping and AdamW
all run on the shards.  The DR front-end runs on the whole (micro-)batch
as the reference's unsplit program does, and its unit stays replicated;
the loss runs on this rank's rows (a MoE layer goes expert-parallel on
the stored expert shards, on the mesh they carry).  With several `model`
ranks the layers split over them: a transformer's stream by sequence where
their count divides it (`api.splits_stream`), Zamba-2's carry by feature
(`api.splits_features`), each rank then holding its share of the loss,
which the step sums over `model` before the DP mean; the dense products,
attention heads, SSD heads and WKV heads tensor-parallel (RWKV-6's stream
whole, its ranks repeating one loss).  The gradients come out in `param_specs`' layout all the
same, so AdamW m / v, clipping and the global norm are unchanged.  Without
a mesh the same body runs as a world of one rank.

`make_dp_compressed_step` is the reference's pure-DP variant: params
replicated, each rank's gradients synced through `compress.compress_sync`
(B3 sketches averaged over the DP axes, error feedback per rank), the loss
averaged over the DP axes.

While a `torch.profiler` profile is active, both steps open `repro_torch.obs`
spans: `train.step` around the call, and inside it `train.feed`,
`train.dr_frontend`, `train.forward`, `train.backward`, `train.optimizer`,
`train.dr_update` (and `train.grad_sync` in the DP step).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core import dr_unit
from repro_torch.core.execution import Execution
from repro_torch.dist import compress as compress_mod
from repro_torch.dist import sharding as shard_rules
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
    grad_compress: Optional[compress_mod.CompressConfig] = None
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


def state_specs(state: TrainState, mesh) -> shard_rules.Specs:
    """{path: spec} of a train state: params and AdamW m / v by
    `param_specs`, everything else replicated (`()`)."""
    pspec = shard_rules.param_specs(state.params, mesh)
    out = {f".params{p}": sp for p, sp in pspec.items()}
    out[".opt.step"] = ()
    for moment in ("m", "v"):
        out.update({f".opt.{moment}{p}": sp for p, sp in pspec.items()})
    if state.dr is not None:
        out.update({".dr.r": (), ".dr.b": (), ".dr.steps": ()})
    out[".step"] = ()
    return out


def lay_out_state(state: TrainState, mesh) -> TrainState:
    """`state` (the same on every rank) laid out on `mesh` by
    `state_specs`."""
    return shard_rules.lay_out(state, state_specs(state, mesh), mesh)


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
        with obs.span("train.dr_frontend"):
            batch = _apply_dr_frontend(dr, dcfg, batch, execution=execution)
        return api.loss_fn(params, batch, cfg.arch, remat=cfg.remat, execution=execution)
    return loss


def value_and_grad(loss_fn, params: Tree, dr, batch) -> Tuple[torch.Tensor, dict, Tree]:
    """(loss, aux, grads in params' nesting) by autograd; a leaf the loss
    does not read gets a zero gradient, as `jax.grad` gives it.

    Spans `train.forward` (the loss) and `train.backward` (autograd).  On
    the card autograd runs the backward on its device thread, so
    `train.backward` is how long the calling thread blocks on it: the
    backward's host time, remat's recomputed forwards included."""
    leaves = [t.detach().requires_grad_(True) for t in opt_mod.tree_leaves(params)]
    with obs.span("train.forward"):
        loss, aux = loss_fn(opt_mod.tree_unflatten(params, leaves), dr, batch)
    with obs.span("train.backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            opt_mod.tree_unflatten(params, grads))


def _micro_batches(batch: Dict[str, torch.Tensor], k: int):
    if k == 1:
        return [batch]
    return [{name: t.reshape((k, t.shape[0] // k) + t.shape[1:])[i] for name, t in batch.items()}
            for i in range(k)]


def _local_batch(batch: Dict[str, torch.Tensor], mesh, split: bool):
    return {name: shard_rules.dp_rows(t, mesh, split) for name, t in batch.items()}


def _relaid(new_local: torch.Tensor, like):
    """`new_local` as a DTensor with `like`'s layout (`like` a DTensor), or
    as it is."""
    if not shard_rules.is_dtensor(like):
        return new_local
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(new_local, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def make_train_step(cfg: TrainConfig, *, execution: Execution = Execution(), mesh=None):
    """Returns `step(state, batch) -> (state, metrics)` on the execution's
    device; `batch` holds CPU or device tensors (`tokens`, and `frames` or
    `patches` for a front-end config).  With `grad_accum` = k > 1 the batch
    is split into k micro-batches along its first axis: their gradients are
    summed and divided by k, the loss averaged, the aux terms dropped, as
    the reference's scan does.  `metrics` holds `loss`, `grad_norm`, `lr`
    and the loss's aux terms.  `mesh=None` is a world of one rank: nothing
    is gathered, split or reduced."""
    shard_rules.check_mesh(mesh)
    dev = execution.torch_device()
    dcfg = _dr_cfg(cfg.arch)
    dax = shard_rules.batch_axes(mesh)
    k = cfg.grad_accum
    no_clip = dataclasses.replace(cfg.opt, grad_clip=None)

    def loss_fn(params, _dr, batch):
        return api.loss_fn(params, batch, cfg.arch, remat=cfg.remat, execution=execution)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with obs.span("train.step"):
            return _step(state, batch)

    def _step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with obs.span("train.feed"):
            batch = {name: torch.as_tensor(shard_rules.full(t)).to(dev)
                     for name, t in batch.items() if name != "step"}
        params, specs = shard_rules.local_specs(state.params)
        gsum, lsum, aux, split, seq = None, 0.0, {}, False, False
        for micro in _micro_batches(batch, k):
            # the front-end's normalisation reads the whole (micro-)batch
            with obs.span("train.dr_frontend"):
                micro = _apply_dr_frontend(state.dr, dcfg, micro, execution=execution)
            split = shard_rules.splits_rows(next(iter(micro.values())).shape[0], mesh)
            # each rank of `model` holds its share of the loss where the
            # transformer's stream splits by sequence or Zamba-2's by feature
            seq = api.splits_stream(cfg.arch, micro, mesh) or api.splits_features(cfg.arch, mesh)
            on_shards = lambda p, _dr, b: loss_fn(  # noqa: E731
                shard_rules.compute_params(p, specs, mesh, split, seq), None, b)
            loss, aux, g = value_and_grad(on_shards, params, None,
                                          _local_batch(micro, mesh, split))
            gsum = g if gsum is None else opt_mod.tree_map(torch.add, gsum, g)
            lsum = lsum + loss
            del g
        with torch.no_grad(), obs.span("train.optimizer"):
            grads = gsum if k == 1 else opt_mod.tree_map(lambda t: t / k, gsum)
            del gsum
            loss, aux = (lsum, aux) if k == 1 else (lsum / k, {})
            if seq:        # each rank of `model` holds its share of the loss
                shard_rules.all_reduce_sum_(loss, mesh, "model")
            if split:
                for t in [loss] + list(aux.values()):
                    shard_rules.all_reduce_mean_(t, mesh, dax)
            gnorm = shard_rules.global_norm(grads, specs, mesh)
            if cfg.opt.grad_clip is not None:
                grads, _ = opt_mod.clip_by_global_norm(grads, cfg.opt.grad_clip, norm=gnorm)
            loc = lambda tree: opt_mod.tree_map(shard_rules.local, tree)  # noqa: E731
            params, opt_state, metrics = opt_mod.apply_updates(
                params, grads, state.opt._replace(m=loc(state.opt.m), v=loc(state.opt.v)),
                no_clip)
            del grads
            metrics["grad_norm"] = gnorm
            relay = lambda new, like: opt_mod.tree_map(_relaid, new, like)  # noqa: E731
            params = relay(params, state.params)
            opt_state = opt_state._replace(m=relay(opt_state.m, state.opt.m),
                                           v=relay(opt_state.v, state.opt.v))
        # DR front-end: streaming EASI update on this batch's raw features,
        # the whole batch on every rank, so the DR unit stays replicated
        dr = state.dr
        if dr is not None:
            with torch.no_grad(), obs.span("train.dr_update"):
                key = "frames" if "frames" in batch else "patches"
                feats = _dr_normalize(batch[key].reshape(-1, cfg.arch.frontend_dim))
                dr = dr_unit.update(dr, dcfg, feats[:DR_UPDATE_ROWS], execution=execution)
        new_state = TrainState(params=params, opt=opt_state, dr=dr, step=state.step + 1)
        return new_state, {"loss": loss, **metrics, **aux}

    return step


# ---------------------------------------------------------------------------
# pure-DP variant with the RP-compressed gradient sync
# ---------------------------------------------------------------------------

def make_dp_compressed_step(cfg: TrainConfig, mesh, *, execution: Execution = Execution(),
                            r: Optional[Dict[int, torch.Tensor]] = None,
                            inspect: Optional[Callable[..., None]] = None):
    """Returns `step(state, batch, ef) -> (state, ef, metrics)`:
    replicated params (plain tensors, the same on every rank), the batch
    split over the DP axes, each rank's gradients (its rows through the DR
    front-end and the loss) synced by `compress_sync` with its own error
    feedback `ef` (start from `compress.residual_init(state.params)`), the
    loss averaged over the DP axes, then AdamW on every rank alike.  The DR
    unit is not updated, as in the reference's.  `r`: the sync's R per leaf
    (parity tests); `inspect(grads, ef, synced, new_ef)` sees each step's
    sync."""
    if cfg.grad_compress is None:
        raise ValueError("make_dp_compressed_step needs TrainConfig.grad_compress")
    shard_rules.check_mesh(mesh)
    if mesh is None:
        raise ValueError("make_dp_compressed_step needs a mesh")
    dev = execution.torch_device()
    dcfg = _dr_cfg(cfg.arch)
    loss_fn = make_loss(cfg, dcfg, execution=execution)
    ax = shard_rules.batch_axes(mesh)
    n_dp = shard_rules.axis_size(mesh, ax)

    def step(state: TrainState, batch, ef):
        with obs.span("train.step"):
            return _step(state, batch, ef)

    def _step(state: TrainState, batch, ef):
        with obs.span("train.feed"):
            batch = {name: torch.as_tensor(shard_rules.full(t)).to(dev)
                     for name, t in batch.items() if name != "step"}
        rows = next(iter(batch.values())).shape[0]
        if rows % n_dp:
            raise ValueError(f"a batch of {rows} rows does not split over {n_dp} DP ranks")
        loss, _, grads = value_and_grad(loss_fn, state.params, state.dr,
                                        _local_batch(batch, mesh, n_dp > 1))
        with torch.no_grad():
            with obs.span("train.grad_sync"):
                synced, new_ef = compress_mod.compress_sync(
                    grads, ef, cfg.grad_compress, ax, mesh=mesh, backend=execution.backend, r=r)
            if inspect is not None:
                inspect(grads, ef, synced, new_ef)
            del grads
            with obs.span("train.optimizer"):
                loss = shard_rules.all_reduce_mean_(loss.clone(), mesh, ax)
                params, opt_state, metrics = opt_mod.apply_updates(state.params, synced,
                                                                   state.opt, cfg.opt)
        return (TrainState(params=params, opt=opt_state, dr=state.dr, step=state.step + 1),
                new_ef, {"loss": loss, **metrics})

    return step
