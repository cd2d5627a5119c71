"""The LM zoo's serving path and the paper's MLP head, in PyTorch.

  config       — `ArchConfig` and its family blocks (a copy of the reference's)
  mlp          — the paper's downstream classifier head (§V-B)
  blocks       — rms_norm, RoPE, flash / decode attention, MLP, init helpers
  transformer  — the dense decoder: init, prefill, decode_step, forward
  api          — family dispatch (only `transformer` is ported)
"""

from repro_torch.models import api, blocks, config, mlp, transformer
from repro_torch.models.config import ArchConfig

__all__ = ["ArchConfig", "api", "blocks", "config", "mlp", "transformer"]
