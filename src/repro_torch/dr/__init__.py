"""repro_torch.dr — the composable stage-graph API for dimensionality
reduction, in PyTorch:

    from repro_torch.dr import DRModel, RPStage, EASIStage, Execution

    model = DRModel(
        stages=(RPStage(32, 16), EASIStage.rotation(16, 8)),
        execution=Execution(backend="kernel"),     # device="cuda" by default
        block_size=32,
    )
    state = model.init(torch.Generator().manual_seed(0))
    state = model.fit(state, x, epochs=3)
    y = model.transform(state, x)

`repro_torch.dr.legacy` maps the legacy `DRConfig` kinds onto stage chains.
"""

from repro_torch.core.execution import KERNEL, TORCH, Execution
from repro_torch.dr.legacy import model_from_config
from repro_torch.dr.model import DREnsemble, DRModel, ModelState
from repro_torch.dr.stages import EASIStage, RPStage, Stage

__all__ = [
    "DRModel", "DREnsemble", "ModelState",
    "Stage", "RPStage", "EASIStage",
    "Execution", "TORCH", "KERNEL",
    "model_from_config",
]
