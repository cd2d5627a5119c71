"""The LM zoo's serving path, in PyTorch.

  config       — `ArchConfig` and its family blocks (a copy of the reference's)
  blocks       — rms_norm, RoPE, flash / decode attention, MLP, init helpers
  transformer  — the dense decoder: init, prefill, decode_step, forward
  api          — family dispatch (only `transformer` is ported)
"""

from repro_torch.models import api, blocks, config, transformer
from repro_torch.models.config import ArchConfig

__all__ = ["ArchConfig", "api", "blocks", "config", "transformer"]
