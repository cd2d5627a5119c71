"""Legacy `DRConfig` → `DRModel` bridge.

The JAX package's `dr/legacy.py`, in PyTorch: the six-way string enum the
old `dr_unit` dispatched on is ONE table, here, mapping each kind to its
stage composition.  `repro_torch.core.dr_unit`'s public functions delegate
through this module.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.core.execution import Execution, resolve
from repro_torch.dr.model import DRModel, ModelState
from repro_torch.dr.stages import EASIStage, RPStage


def model_from_config(cfg: Any, *, execution: Optional[Execution] = None) -> DRModel:
    """Build the DRModel equivalent of a legacy `dr_unit.DRConfig`.

    `cfg` is duck-typed (kind/m/n/p/mu/...) to keep this module import-free
    of `dr_unit` (which imports us).
    """
    exe = resolve(execution)
    easi_kw = dict(mu=cfg.mu, g=cfg.g, normalized=cfg.normalized,
                   init_mode=cfg.init, dtype=cfg.dtype)

    def rp(m, p):
        return RPStage(m=m, p=p, sparsity=cfg.rp_sparsity, dtype=cfg.dtype)

    kind = cfg.kind
    if kind == "rp":
        stages: Tuple = (rp(cfg.m, cfg.n),)
    elif kind == "whiten":
        stages = (EASIStage.whiten(cfg.m, cfg.n, **easi_kw),)
    elif kind == "easi":
        stages = (EASIStage.full(cfg.m, cfg.n, **easi_kw),)
    elif kind == "rotation":
        stages = (EASIStage.rotation(cfg.m, cfg.n, **easi_kw),)
    elif kind == "rp_easi":
        # THE PAPER'S PROPOSAL: RP m→p, then EASI p→n with the whitening
        # term bypassed (Table I rows 2/4 keep it via bypass_whitening=False).
        stages = (rp(cfg.m, cfg.p),
                  EASIStage(m=cfg.p, n=cfg.n,
                            second_order=not cfg.bypass_whitening,
                            higher_order=True, **easi_kw))
    elif kind == "rp_whiten":
        stages = (rp(cfg.m, cfg.p), EASIStage.whiten(cfg.p, cfg.n, **easi_kw))
    else:
        raise ValueError(f"unknown DR kind {kind!r}")

    return DRModel(stages=stages, execution=exe, block_size=cfg.block_size)


def legacy_to_model_state(model: DRModel, legacy_state: Any) -> ModelState:
    """Repack a legacy `dr_unit.DRState(r, b, steps)` as a ModelState."""
    states = []
    for stage in model.stages:
        states.append(legacy_state.b if stage.trainable else legacy_state.r)
    return ModelState(stages=tuple(states), steps=legacy_state.steps,
                      trainable=model.trainable_mask)


def model_to_legacy_fields(state: ModelState) -> Tuple[Any, Any, Any]:
    """(r, b, steps) of a ModelState, for repacking into a legacy DRState."""
    return state.r, state.b, state.steps
