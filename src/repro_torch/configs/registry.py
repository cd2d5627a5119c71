"""Assigned-architecture registry: exact configs + reduced smoke variants.

Every entry matches the assignment table verbatim ([source; tier] in the
per-arch module docstrings).  `smoke(cfg)` shrinks width/depth within the
same family so CPU tests exercise identical code paths.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "smollm_135m",
    "h2o_danube3_4b",
    "yi_6b",
    "starcoder2_7b",
    "rwkv6_1b6",
    "hubert_xlarge",
    "internvl2_1b",
    "zamba2_7b",
    "phi35_moe",
    "dbrx_132b",
]

# assignment ids use dashes; keep a mapping for CLIs
ALIASES = {
    "smollm-135m": "smollm_135m",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "yi-6b": "yi_6b",
    "starcoder2-7b": "starcoder2_7b",
    "rwkv6-1.6b": "rwkv6_1b6",
    "hubert-xlarge": "hubert_xlarge",
    "internvl2-1b": "internvl2_1b",
    "zamba2-7b": "zamba2_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "dbrx-132b": "dbrx_132b",
}


def get(arch_id: str) -> ArchConfig:
    arch_id = ALIASES.get(arch_id, arch_id)
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    arch_id = ALIASES.get(arch_id, arch_id)
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.SMOKE


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get(a) for a in ARCH_IDS}
