"""The DR front-end of the JAX package's `train/train_step.py`.

Only what turns raw modality features into the reduced features that a
`dr_frontend` config's `prefill` reads is ported: `_dr_cfg` (the legacy
`DRConfig` a `DRFrontendSpec` describes), `_dr_normalize` (centre + one
global scalar scale) and `_apply_dr_frontend` (frames or patches through
`dr_unit.transform`).  The reference's train step also folds each batch
into the DR state with `dr_unit.update` on the first 4096 normalised rows;
a caller does that with `dr_unit.update` directly.  The train step itself
(loss, gradients, AdamW over the LM, the DR unit co-trained inside it)
waits for ROADMAP A9g / A10.

The reference's `_apply_dr_frontend` calls `dr_unit.transform` with the
default backend; here the caller's `Execution` is passed through, so with
`backend="kernel"` the front-end runs the DR kernels (the reference API's
`use_kernel=True`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import dr_unit
from repro_torch.core.execution import Execution
from repro_torch.models.config import ArchConfig


def _dr_cfg(arch: ArchConfig) -> Optional[dr_unit.DRConfig]:
    spec = arch.dr_frontend
    if spec is None:
        return None
    return dr_unit.DRConfig(
        kind=spec.kind, m=arch.frontend_dim, p=spec.p, n=spec.n,
        mu=spec.mu, block_size=1, bypass_whitening=spec.bypass_whitening)


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
    reduced features (B, S, n); the batch as given without a DR state."""
    if state_dr is None:
        return batch
    key = "frames" if "frames" in batch else "patches"
    feats = batch[key]
    b, s, fd = feats.shape
    flat = _dr_normalize(feats.reshape(b * s, fd))
    red = dr_unit.transform(state_dr, dcfg, flat, execution=execution)
    return {**batch, key: red.reshape(b, s, -1)}
