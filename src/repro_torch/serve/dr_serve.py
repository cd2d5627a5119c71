"""Sharded DR inference endpoint — the LM serving treatment for DR models.

The JAX package's `serve/dr_serve.py` over a `DeviceMesh`.
`make_dr_transform` builds one `transform` for a `DRModel` on a mesh:
stage states are replicated (the model's `shard_specs`: R and B are tiny),
the feature batch shards its leading dim over the data-parallel axes, and
the output comes back in the reference's layout (`(dax,)`, or
`(None, dax)` for an ensemble) as a DTensor:

    mesh = make_smoke_mesh()
    step = dr_serve.make_dr_transform(model, mesh)
    y = step(state, x)        # x (B, m): every rank's whole batch, or a DTensor

Each rank runs the model's own `transform` — under the kernel backend the
fused project + whiten kernel — on its local rows only; nothing crosses
ranks inside the step.  `local=` replaces that per-rank call (the serving
engine passes its captured bucket program there).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.dist import sharding as shard_rules
from repro_torch.serve.batching import BoundedCompileCache


def _local_state(state):
    """A state whose stage tensors may be replicated DTensors, as local
    tensors (the kernels take local tensors only)."""
    return state._replace(stages=tuple(shard_rules.local(s) for s in state.stages))


def make_dr_transform(model, mesh, *, batch_size: Optional[int] = None,
                      ensemble: Optional[int] = None,
                      local: Optional[Callable[..., torch.Tensor]] = None):
    """Returns `step(state, x) -> y` on `mesh`, y a DTensor.

    `batch_size`: if given, the batch stays replicated when the DP axes do
    not divide it (ragged client batches still serve).  `ensemble`: a
    k-member ensemble state (a leading (k,) axis on every leaf; the output
    gains a leading k dim)."""
    shard_rules.check_mesh(mesh)
    dax = shard_rules.batch_axes(mesh)
    n_dp = shard_rules.axis_size(mesh, dax)
    shard_batch = shard_rules.splits_rows(n_dp if batch_size is None else batch_size, mesh)
    rows_spec = dax if shard_batch else None
    if ensemble is not None:
        fn = model.ensemble(ensemble).transform
        out_spec, rows_dim = (None, rows_spec, None), 1
    else:
        fn = model.transform
        out_spec, rows_dim = (rows_spec, None), 0
    run = local if local is not None else fn
    dev = model.execution.torch_device()

    def step(state, x) -> Any:
        from torch.distributed.tensor import DTensor

        x = torch.as_tensor(shard_rules.full(x))
        if shard_batch and x.shape[0] % n_dp:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split over the "
                             f"{n_dp} DP ranks this transform was built for")
        y = run(_local_state(state), shard_rules.dp_rows(x, mesh, shard_batch).to(dev))
        shape = list(y.shape)
        if shard_batch:
            shape[rows_dim] *= n_dp
        return DTensor.from_local(y, mesh, shard_rules.placements(out_spec, mesh),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=shard_rules.contiguous_stride(shape))

    return step


# Bounded LRU over built steps (an unbounded cache pins every mesh a step
# was ever built for).  `DRService` keeps its own; this one backs the
# module-level convenience call.
_CACHE = BoundedCompileCache(maxsize=64)


def _cached_transform(model, mesh, shard_batch: bool):
    # batch_size=None → shard the batch axis; 1 → force the replicated layout
    return _CACHE.get_or_build(
        (model, mesh, shard_batch),
        lambda: make_dr_transform(model, mesh, batch_size=None if shard_batch else 1))


def dr_transform(model, state, x, *, mesh=None):
    """One-shot convenience: the sharded step (built once per (model, mesh,
    layout) and cached).  Without a mesh this is `model.transform`."""
    if mesh is None:
        return model.transform(state, x)
    return _cached_transform(model, mesh, shard_rules.splits_rows(x.shape[0], mesh))(state, x)
