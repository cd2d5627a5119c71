"""The dense transformer family: its sizes, its parameter leaves and its
operations, as `families/__init__.py` lists them.  Weights N(0, 1/d_in)
for a dense leaf, the output projections scaled by 1/sqrt(2·L·d_in), ones
for the norms; a model step's operations as `flops.py` sets them out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

from portbench.flops import BF16, F32, PEAK_BF16_FLOPS, bound_s, frontend_in


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
    dr_frontend: Any          # arch.DRSpec or None
    moe: Any = None

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return -(-self.vocab_size // m) * m


def sizes(fields, dr) -> Arch:
    return Arch(dr_frontend=dr, **fields)


def port_config(arch: Arch):
    """The port's `ArchConfig` of the same sizes."""
    from repro_torch.models.config import ArchConfig, DRFrontendSpec

    f = {k.name: getattr(arch, k.name) for k in dataclasses.fields(arch)}
    dr = f.pop("dr_frontend")
    return ArchConfig(dr_frontend=None if dr is None else DRFrontendSpec(**dataclasses.asdict(dr)),
                      **f)


def leaf_specs(arch) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(path, shape, scale) of every parameter leaf, paths as `layers/wq`;
    a scale of 0 marks a norm's ones.  Dense layers only."""
    if arch.moe is not None:
        raise ValueError(f"{arch.name}: the dense family draws no experts")
    d, dh, hq, hkv, f, n_l = (arch.d_model, arch.dh, arch.n_heads, arch.n_kv_heads, arch.d_ff,
                              arch.n_layers)
    v = arch.padded_vocab
    out = [("embed", (v, d), 1.0),
           ("final_norm", (d,), 0.0),
           ("layers/ln1", (n_l, d), 0.0),
           ("layers/ln2", (n_l, d), 0.0),
           ("layers/wq", (n_l, d, hq * dh), 1.0 / math.sqrt(d)),
           ("layers/wk", (n_l, d, hkv * dh), 1.0 / math.sqrt(d)),
           ("layers/wv", (n_l, d, hkv * dh), 1.0 / math.sqrt(d)),
           ("layers/wo", (n_l, hq * dh, d), 1.0 / math.sqrt(2 * n_l * hq * dh)),
           ("layers/w_in", (n_l, d, f), 1.0 / math.sqrt(d)),
           ("layers/w_out", (n_l, f, d), 1.0 / math.sqrt(2 * n_l * f))]
    if arch.gated_mlp:
        out.append(("layers/w_gate", (n_l, d, f), 1.0 / math.sqrt(d)))
    if not arch.tie_embeddings:
        out.append(("lm_head", (d, v), 1.0 / math.sqrt(d)))
    if arch.frontend is not None:
        f_in = arch.dr_frontend.n if arch.dr_frontend is not None else arch.frontend_dim
        out.append(("frontend_proj", (f_in, d), 1.0 / math.sqrt(f_in)))
    return sorted(out)


def layer_params(a) -> int:
    """Weights one token meets in one layer's products."""
    d, dh, hq, hkv, f = a.d_model, a.dh, a.n_heads, a.n_kv_heads, a.d_ff
    return d * hq * dh + 2 * d * hkv * dh + hq * dh * d + (3 if a.gated_mlp else 2) * d * f


def attention_pairs(a, s: int) -> float:
    """Query-key pairs one head scores over a sequence of s."""
    return s * (s + 1) / 2 if a.causal else float(s * s)


def attention_forward(a, batch: int, s: int) -> float:
    """4 · pairs · Dh a head, every head, every layer."""
    return 4.0 * batch * attention_pairs(a, s) * a.n_heads * a.dh * a.n_layers


def train_flops(a, batch: int, s: int) -> float:
    """One training step on `batch` sequences of s positions, every position
    a target (the encoder's masked units)."""
    tokens = batch * s
    n = a.n_layers * layer_params(a) + a.d_model * a.padded_vocab
    if a.frontend is not None:
        n += frontend_in(a) * a.d_model
    return 6.0 * n * tokens + 3.0 * attention_forward(a, batch, s)


def prefill_flops(a, batch: int, s: int, prefix_rows: int) -> float:
    """One prefill of `batch` streams of s positions, of which `prefix_rows`
    a stream come through the front-end projection; the head runs on the
    last position only."""
    f = 2.0 * a.n_layers * layer_params(a) * batch * s
    f += 2.0 * a.d_model * a.padded_vocab * batch
    if a.frontend is not None:
        f += 2.0 * frontend_in(a) * a.d_model * batch * prefix_rows
    return f + attention_forward(a, batch, s)


def decode_flops(a, batch: int, s: int, steps: int) -> float:
    """`steps` decode steps of `batch` streams after a prompt of s: each
    step one position through every layer and the head, its query scoring
    every key in the cache, its own included (s + 1 keys at the first)."""
    keys = steps * s + steps * (steps + 1) / 2
    f = 2.0 * (a.n_layers * layer_params(a) + a.d_model * a.padded_vocab) * batch * steps
    return f + 4.0 * batch * keys * a.n_heads * a.dh * a.n_layers


def flash_bound_s(a, batch: int, s: int, lse: bool) -> float:
    """B4 on one layer: q, k, v read and the output written in bf16, each
    row's log-sum-exp in f32 where the training forward writes it."""
    q = batch * s * a.n_heads * a.dh
    kv = 2 * batch * s * a.n_kv_heads * a.dh
    nbytes = BF16 * (2 * q + kv) + (F32 * batch * s * a.n_heads if lse else 0)
    return bound_s(4.0 * batch * attention_pairs(a, s) * a.n_heads * a.dh, nbytes,
                   PEAK_BF16_FLOPS)
