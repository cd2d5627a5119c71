"""numpy ↔ torch for model states and LM parameters.

PyTorch cannot reproduce the JAX package's random draws, so a state made
there (R, B₀, a whole `ModelState`, or an LM's parameter pytree) crosses
over as numpy arrays: the reference's leaves go through `numpy.asarray`,
`from_reference` loads them into a port `ModelState`,
`dr_state_from_reference` into a legacy `dr_unit.DRState`, and
`params_from_reference` into the port's parameter dict (same keys, same
stacked `[L, ...]` layout), `train_state_from_reference` into a
`train.train_step.TrainState` (params, AdamW `m` / `v` / `step`, the DR
state, the step); `to_numpy`, `params_to_numpy` and `train_state_to_numpy`
turn them back into numpy leaves.  Only the attributes `stages`, `steps`
and `trainable` (or `r`, `b` and `steps`; `params`, `opt`, `dr` and
`step`; `step`, `m` and `v`) of a source state are read, so nothing of
the JAX package is imported.

Like every entry point of the port, the loaders put tensors on the card
unless the caller passes `device="cpu"`; with no card they raise.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.core.dr_unit import DRState
from repro_torch.core.execution import resolve_device
from repro_torch.dr.model import ModelState
from repro_torch.train.optimizer import OptState
from repro_torch.train.train_step import TrainState


def to_tensor(a, device="cuda") -> torch.Tensor:
    """numpy array (or array-like) → tensor on `device`.  A bfloat16 numpy
    array (the ml_dtypes type JAX hands out) crosses bit for bit.  The data
    is copied: the tensor never shares memory with the source."""
    dev = resolve_device(device)
    arr = np.array(a, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def to_array(t: torch.Tensor) -> np.ndarray:
    """tensor → numpy on the host; bfloat16 widens to float32 (exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def from_reference(ref_state: Any, *, device="cuda") -> ModelState:
    """A port `ModelState` holding the reference state's arrays."""
    stages = tuple(None if s is None else to_tensor(s, device) for s in ref_state.stages)
    steps = torch.tensor(int(np.asarray(ref_state.steps)), dtype=torch.int32)
    return ModelState(stages=stages, steps=steps, trainable=ref_state.trainable)


def dr_state_from_reference(ref_state: Any, *, device="cuda") -> DRState:
    """A port `DRState` holding a reference `dr_unit.DRState`'s R, B and
    step count."""
    def load(a):
        return None if a is None else to_tensor(a, device)

    return DRState(r=load(ref_state.r), b=load(ref_state.b),
                   steps=torch.tensor(int(np.asarray(ref_state.steps)), dtype=torch.int32))


def to_numpy(state: ModelState) -> Tuple[Tuple[Any, ...], np.int32, Any]:
    """(stages as numpy arrays, steps as np.int32, trainable mask)."""
    stages = tuple(None if s is None else to_array(s) for s in state.stages)
    return stages, np.int32(int(state.steps)), state.trainable


def params_from_reference(tree: Any, *, device="cuda") -> Any:
    """The port's parameter dict from a reference pytree of arrays (nested
    dicts, lists and tuples, as `jax.tree.map(numpy.asarray, params)`
    gives): the same keys, each leaf through `to_tensor`."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device=dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_reference(v, device=dev) for v in tree)
    return to_tensor(tree, dev)


def params_to_numpy(params: Any) -> Any:
    """The port's parameter dict (or any nested dict / list of tensors, a
    kv cache for instance) as numpy leaves, through `to_array`."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to_numpy(v) for v in params)
    return to_array(params)


def _host_int32(a) -> torch.Tensor:
    return torch.tensor(int(np.asarray(a)), dtype=torch.int32)


def train_state_from_reference(ref_state: Any, *, device="cuda"):
    """A port `TrainState` holding a reference `TrainState`'s params, AdamW
    moments and step, DR state (or None) and step; the counters as int32
    scalars on the host, as the port keeps them."""
    dev = resolve_device(device)
    opt = ref_state.opt
    dr = None if ref_state.dr is None else dr_state_from_reference(ref_state.dr, device=dev)
    return TrainState(
        params=params_from_reference(ref_state.params, device=dev),
        opt=OptState(step=_host_int32(opt.step), m=params_from_reference(opt.m, device=dev),
                     v=params_from_reference(opt.v, device=dev)),
        dr=dr, step=_host_int32(ref_state.step))


def train_state_to_numpy(state: Any):
    """The port `TrainState` with numpy leaves (counters as np.int32), in
    the same nesting."""
    dr = None
    if state.dr is not None:
        dr = DRState(r=None if state.dr.r is None else to_array(state.dr.r),
                     b=None if state.dr.b is None else to_array(state.dr.b),
                     steps=np.int32(int(state.dr.steps)))
    return TrainState(
        params=params_to_numpy(state.params),
        opt=OptState(step=np.int32(int(state.opt.step)), m=params_to_numpy(state.opt.m),
                     v=params_to_numpy(state.opt.v)),
        dr=dr, step=np.int32(int(state.step)))
