"""numpy ↔ torch for model states.

PyTorch cannot reproduce the JAX package's random draws, so a state made
there (R, B₀ or a whole `ModelState`) crosses over as numpy arrays: the
reference state's leaves go through `numpy.asarray`, and `from_reference`
loads them into a port `ModelState`; `to_numpy` turns a port state back
into numpy leaves.  Only the attributes `stages`, `steps` and `trainable`
of the source object are read, so nothing of the JAX package is imported.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.dr.model import ModelState


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy array (or array-like) → tensor on `device`.  A bfloat16 numpy
    array (the ml_dtypes type JAX hands out) crosses bit for bit.  The data
    is copied: the tensor never shares memory with the source."""
    arr = np.array(a, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def to_array(t: torch.Tensor) -> np.ndarray:
    """tensor → numpy on the host; bfloat16 widens to float32 (exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def from_reference(ref_state: Any, *, device="cpu") -> ModelState:
    """A port `ModelState` holding the reference state's arrays."""
    stages = tuple(None if s is None else to_tensor(s, device) for s in ref_state.stages)
    steps = torch.tensor(int(np.asarray(ref_state.steps)), dtype=torch.int32)
    return ModelState(stages=stages, steps=steps, trainable=ref_state.trainable)


def to_numpy(state: ModelState) -> Tuple[Tuple[Any, ...], np.int32, Any]:
    """(stages as numpy arrays, steps as np.int32, trainable mask)."""
    stages = tuple(None if s is None else to_array(s) for s in state.stages)
    return stages, np.int32(int(state.steps)), state.trainable
