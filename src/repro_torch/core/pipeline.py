"""Two-stage training pipeline (paper §V-B).

  Stage 1 — train the DR model unsupervised on raw features.
  Stage 2 — transform the dataset and train a downstream head
            (paper: MLP, 2 hidden layers × 64) on the reduced features.

The JAX package's `core/pipeline.py`, in PyTorch.  `TwoStageConfig.dr`
accepts either a `repro_torch.dr.DRModel` or a legacy `dr_unit.DRConfig`
(bridged through `dr_unit.from_legacy`); the execution policy (backend and
device) is whatever the model was built with, overridable per call via
`execution=`.  Inputs may be numpy arrays or tensors; they go to the
execution's device.

Preprocessing convention (see EXPERIMENTS.md §Paper-parity): the DR stage
sees *centred* data rescaled by ONE global scalar (mean per-dim variance →
1), which keeps the signal-vs-noise variance gap that dimensionality
reduction exploits; the head input (reduced features) is then per-feature
standardised.  Variances are population variances (`correction=0`), as
`jnp.var` / `jnp.std` compute them.

Random draws: the reference splits `PRNGKey(seed)` into (k_dr, k_head,
k_shuf).  PyTorch cannot reproduce those draws, so `generators(seed)` gives
three CPU `torch.Generator`s seeded from the three children of
`numpy.random.SeedSequence(seed)`: the DR init, the head init and the
epoch shuffles.  They live on the CPU whatever the execution's device, so
one seed gives the same initial state and the same shuffles on the CPU and
on the card, under either backend.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import dr_unit
from repro_torch.core.execution import Execution, resolve


@dataclasses.dataclass(frozen=True)
class TwoStageConfig:
    dr: Union[dr_unit.DRConfig, "Any"]        # DRConfig or repro_torch.dr.DRModel
    dr_epochs: int = 3
    head_hidden: Tuple[int, ...] = (64, 64)   # paper §V-B
    head_classes: int = 3
    head_lr: float = 5e-4
    head_wd: float = 1e-2
    head_epochs: int = 60
    head_batch: int = 128
    seed: int = 0


def generators(seed: int) -> Tuple[torch.Generator, torch.Generator, torch.Generator]:
    """(DR init, head init, shuffles): CPU generators seeded from the three
    children of `numpy.random.SeedSequence(seed)`."""
    children = np.random.SeedSequence(seed).spawn(3)
    return tuple(torch.Generator().manual_seed(int(c.generate_state(1, np.uint64)[0]))
                 for c in children)


def as_model(dr, *, execution: Optional[Execution] = None, use_kernel: bool = False):
    """Normalise a DRConfig-or-DRModel to a DRModel, optionally overriding
    its execution policy (an explicit `execution` always wins)."""
    from repro_torch.dr.model import DRModel

    if isinstance(dr, DRModel):
        if execution is not None or use_kernel:
            return dr.with_execution(resolve(execution, use_kernel))
        return dr
    return dr_unit.from_legacy(dr, execution=execution, use_kernel=use_kernel)


def _on(x, device: torch.device, dtype=None) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def standardize(x: torch.Tensor, stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Per-feature zero-mean/unit-var (head-input hygiene)."""
    if stats is None:
        mean = torch.mean(x, dim=0)
        std = torch.std(x, dim=0, correction=0) + 1e-8
    else:
        mean, std = (_on(s, x.device) for s in stats)
    return (x - mean) / std, (mean, std)


def center_global_scale(x: torch.Tensor, stats=None):
    """Centre + ONE scalar scale (mean per-dim variance -> 1). DR-stage prep."""
    if stats is None:
        mean = torch.mean(x, dim=0)
        scale = torch.sqrt(torch.mean(torch.var(x - mean, dim=0, correction=0))) + 1e-8
    else:
        mean, scale = (_on(s, x.device) for s in stats)
    return (x - mean) / scale, (mean, scale)


def fit_two_stage(
    cfg: TwoStageConfig,
    x_train,
    y_train,
    *,
    use_kernel: bool = False,
    execution: Optional[Execution] = None,
) -> Dict[str, Any]:
    """Returns dict with dr_model, dr_state, head params, and stats tuples."""
    from repro_torch.models import mlp  # local import to keep core standalone

    model = as_model(cfg.dr, execution=execution, use_kernel=use_kernel)
    dev = model.execution.torch_device()
    g_dr, g_head, g_shuf = generators(cfg.seed)
    x_train = _on(x_train, dev, torch.float32)
    y_train = _on(y_train, dev, torch.int64)

    x_dr, dr_stats = center_global_scale(x_train)
    dr_state = model.init(g_dr)
    dr_state = model.fit(dr_state, x_dr, epochs=cfg.dr_epochs)

    feats = model.transform(dr_state, x_dr)
    feats_std, head_stats = standardize(feats)
    head = mlp.init(g_head, feats.shape[-1], cfg.head_hidden, cfg.head_classes, device=dev)
    head = mlp.fit(
        head, feats_std, y_train,
        lr=cfg.head_lr, wd=cfg.head_wd, epochs=cfg.head_epochs, batch=cfg.head_batch,
        generator=g_shuf,
    )
    return {"dr_model": model, "dr_state": dr_state, "head": head,
            "dr_stats": dr_stats, "head_stats": head_stats, "cfg": cfg}


def predict(model: Dict[str, Any], x, *,
            use_kernel: bool = False, execution: Optional[Execution] = None) -> torch.Tensor:
    from repro_torch.models import mlp

    cfg: TwoStageConfig = model["cfg"]
    dr_model = model.get("dr_model")
    if dr_model is None or execution is not None or use_kernel:
        dr_model = as_model(cfg.dr if dr_model is None else dr_model,
                            execution=execution, use_kernel=use_kernel)
    dr_state = model["dr_state"]
    if isinstance(dr_state, dr_unit.DRState):  # pre-refactor model dicts
        from repro_torch.dr import legacy

        dr_state = legacy.legacy_to_model_state(dr_model, dr_state)
    x = _on(x, dr_model.execution.torch_device(), torch.float32)
    x_dr, _ = center_global_scale(x, model["dr_stats"])
    feats = dr_model.transform(dr_state, x_dr)
    feats_std, _ = standardize(feats, model["head_stats"])
    return mlp.apply(model["head"], feats_std)


def evaluate(model: Dict[str, Any], x_test, y_test, *,
             use_kernel: bool = False, execution: Optional[Execution] = None) -> float:
    logits = predict(model, x_test, use_kernel=use_kernel, execution=execution)
    y_test = _on(y_test, logits.device, torch.int64)
    return float(torch.mean((torch.argmax(logits, -1) == y_test).to(torch.float32)))
