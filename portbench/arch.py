"""A configuration file of `configs/`, read into the benchmark's own view of
its sizes (`Arch`), and into the port's `ArchConfig` for the program.

The benchmark's view holds only numbers, so the weights, the counts of
operations and bytes, and the reference read the sizes without importing
anything of the program.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class DRSpec:
    kind: str
    p: int
    n: int
    mu: float
    bypass_whitening: bool


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float
    causal: bool
    frontend: Optional[str]
    frontend_dim: int
    frontend_seq: int
    act: str
    gated_mlp: bool
    norm_eps: float
    tie_embeddings: bool
    param_dtype: str
    compute_dtype: str
    vocab_pad_to: int
    q_chunk: int
    kv_chunk: int
    dr_frontend: Optional[DRSpec]
    moe: Any = None

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return -(-self.vocab_size // m) * m


def read(path: Path) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())


def sizes(arch_fields: Dict[str, Any], overrides: Optional[Dict[str, Any]] = None) -> Arch:
    """The benchmark's `Arch` of a configuration file's `arch` object."""
    f = dict(arch_fields, **(overrides or {}))
    dr = f.pop("dr_frontend", None)
    return Arch(dr_frontend=None if dr is None else DRSpec(**dr), **f)


def port_config(arch: Arch):
    """The port's `ArchConfig` of the same sizes."""
    from repro_torch.models.config import ArchConfig, DRFrontendSpec

    f = {k.name: getattr(arch, k.name) for k in dataclasses.fields(arch)}
    dr = f.pop("dr_frontend")
    return ArchConfig(dr_frontend=None if dr is None else DRFrontendSpec(**dataclasses.asdict(dr)),
                      **f)
