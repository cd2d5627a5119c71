"""The paper's reconfigurable dimensionality reduction, in PyTorch.

  random_projection — sparse ternary RP (Fox'16 distribution), int8 storage
  easi              — EASI ICA update (Eq. 6) + rotation-only variant (Eq. 5)
  whitening         — adaptive PCA whitening (Eq. 3) = EASI with HOS muxed out
  execution         — Execution policy: backend ("torch" | "kernel"), device,
                      compute dtype — resolved once at model build
  dr_unit           — the legacy DRConfig / DRState facade over the stages
  pipeline          — the two-stage DR + MLP-head pipeline (paper §V-B)

The composable stage graph (RPStage / EASIStage / DRModel) lives in
`repro_torch.dr`.
"""

from repro_torch.core import dr_unit, easi, execution, pipeline, random_projection, whitening
from repro_torch.core.dr_unit import DRConfig, DRState
from repro_torch.core.easi import EASIConfig, amari_distance, whiteness_kl
from repro_torch.core.execution import Execution
from repro_torch.core.random_projection import RPConfig

__all__ = [
    "dr_unit", "easi", "execution", "pipeline", "random_projection", "whitening",
    "DRConfig", "DRState", "EASIConfig", "Execution", "RPConfig", "amari_distance",
    "whiteness_kl",
]
