"""Unified architecture config covering every assigned family.

A copy of the JAX package's `models/config.py` (it holds no JAX), so the
port reads the same frozen dataclasses without importing the reference:
one `ArchConfig` drives param init, prefill and decode of the dense
transformers; the family-specific blocks (`MoESpec`, `SSMSpec`,
`HybridSpec`, `DRFrontendSpec`) are carried as data even where the port
does not run them yet.  `repr` and field order match the reference, so
`checkpoint.manager.config_hash` gives the same hash in both packages.
`GroupedSSMSpec` and `SharedBlocksSpec` are the port's own subclasses for
Zamba2's published layout; a config built from the shared classes alone is
the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    """Mamba-2 (SSD) block geometry."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridSpec:
    """Zamba-2 layout: SSM backbone + one *shared* attention block applied
    every `attn_every` layers (shared weights, concat re-projection)."""
    attn_every: int = 6


@dataclasses.dataclass(frozen=True)
class GroupedSSMSpec(SSMSpec):
    """Port only (the JAX package has no such block): Mamba-2 as Zamba2
    publishes it (`mamba_ngroups`).  B and C come in `n_groups` groups of
    d_state, SSD head h reading group h // (heads / n_groups); the output y
    is gated by silu(z) first and then RMS-normed over each group of
    d_inner / n_groups channels (HF's `Zamba2RMSNormGated`).  The JAX
    package's `SSMSpec` is one group, normed over all of d_inner, then
    gated."""
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class SharedBlocksSpec(HybridSpec):
    """Port only: Zamba2's published hybrid layout.  `n_blocks` shared
    attention + MLP blocks, used in alternation at the layers `layer_ids`
    (use j runs block j % n_blocks), each use with its own LoRA adapter of
    rank `adapter_rank` on the MLP's gate_up and its own d × d output
    Linear; the attention's scores are scaled by (Dh / 2)^-1/2, as HF's
    `Zamba2Attention` scales them.  The block's output feeds only the next
    Mamba layer's input (x + Mamba(norm(x + W_j·T))).  `attn_every` is not
    read."""
    layer_ids: Tuple[int, ...] = ()
    n_blocks: int = 1
    adapter_rank: int = 0


@dataclasses.dataclass(frozen=True)
class DRFrontendSpec:
    """The paper's technique as an input-feature front-end (audio/VLM stubs):
    raw frontend features (d_frontend) -> RP (p) -> EASI (n) -> linear to
    d_model. Trained by the EASI rule (streaming, unsupervised) inside the
    train loop — the two-stage pipeline fused into one pass."""
    kind: str = "rp_easi"      # any repro.core.dr_unit kind
    p: Optional[int] = None
    n: Optional[int] = None
    mu: float = 2e-4
    bypass_whitening: bool = True


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # transformer | rwkv6 | zamba
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    # attention geometry (transformer / hybrid shared block)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None
    causal: bool = True              # False => encoder-only (no decode path)
    # blocks
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    hybrid: Optional[HybridSpec] = None
    # modality frontend stub ([audio]/[vlm]): precomputed embeddings enter
    # through a linear (+ optional DR) instead of the token embedding.
    frontend: Optional[str] = None   # None | "audio" | "vision"
    frontend_dim: int = 0
    frontend_seq: int = 0            # patches/frames per sample (vlm prepend)
    dr_frontend: Optional[DRFrontendSpec] = None
    # numerics
    act: str = "silu"
    gated_mlp: bool = True           # False = plain 2-matrix MLP (starcoder2)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "float32"     # master params
    compute_dtype: str = "bfloat16"
    vocab_pad_to: int = 256          # pad vocab so big tables shard evenly
    # attention chunking (flash-style scan) — memory-bounding for long seq
    q_chunk: int = 1024
    kv_chunk: int = 1024
    # microbatching for the train_4k cell (memory-bound recurrent stacks)
    train_grad_accum: int = 1
    # RP-compressed KV cache (beyond-paper, derived from the paper's RP
    # stage): keys stored as K·R with ternary R (dh -> dh//kv_rp); scores
    # use q·R — Johnson–Lindenstrauss preserves ⟨q,k⟩.  V stays exact.
    kv_rp: Optional[int] = None

    # ---- derived ----
    @property
    def dh(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    def validate(self) -> None:
        if self.family == "transformer":
            assert self.n_heads > 0 and self.n_kv_heads > 0
            assert self.n_heads % self.n_kv_heads == 0
        if self.family == "zamba":
            assert self.ssm is not None and self.hybrid is not None
        if self.family == "rwkv6":
            assert self.d_model % 64 == 0, "rwkv6 heads are d_model/64"
        if self.frontend is not None:
            assert self.frontend_dim > 0

    # ---- parameter count (for 6ND model-flops accounting) ----
    def param_count(self, active_only: bool = False) -> int:
        d, l, v = self.d_model, self.n_layers, self.padded_vocab
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        if self.family == "transformer":
            dh, hq, hkv = self.dh, self.n_heads, self.n_kv_heads
            attn = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
            if self.moe:
                e = self.moe.top_k if active_only else self.moe.n_experts
                ffn = d * self.moe.n_experts  # router (always dense)
                ffn += e * (3 * d * self.moe.d_ff_expert)
            else:
                ffn = 3 * d * self.d_ff
            total += l * (attn + ffn + 2 * d)
        elif self.family == "rwkv6":
            di = d
            tm = 6 * d * di + di * d + 64 * d * 10  # r,k,v,g,w,o + lora-ish decay
            cm = 2 * d * self.d_ff // 2 + self.d_ff // 2 * d  # rwkv ffn (r,k,v)
            cm = d * self.d_ff + self.d_ff * d + d * d
            total += l * (tm + cm + 2 * d)
        elif self.family == "zamba" and isinstance(self.hybrid, SharedBlocksSpec):
            total += l * zamba_layer_params(self) + published_shared_params(self) + d
        elif self.family == "zamba":
            di = self.ssm.d_inner(d)
            nh = self.ssm.n_heads(d)
            mamba = d * (2 * di + 2 * self.ssm.d_state + nh) + di * d \
                + di * self.ssm.d_conv + nh
            total += l * (mamba + 2 * d)
            # one shared attention+mlp block (+ concat proj)
            dh, hq, hkv = self.dh, self.n_heads, self.n_kv_heads
            shared = (2 * d) * hq * dh + 2 * (2 * d) * hkv * dh + hq * dh * d \
                + 3 * d * self.d_ff + 2 * d * d
            total += shared
        if self.frontend:
            total += self.frontend_dim * d
        return int(total)

    def model_flops_per_token(self, decode: bool = False) -> float:
        """6·N_active per trained token (2·N for decode)."""
        n = self.param_count(active_only=True)
        return (2.0 if decode else 6.0) * n


def zamba_layer_params(cfg: ArchConfig) -> int:
    """One Mamba-2 layer of the published Zamba2 layout (`GroupedSSMSpec`):
    its norm, `in_proj`, the conv's taps and bias, A, D and the dt bias,
    the gated norm and `out_proj`."""
    d, spec = cfg.d_model, cfg.ssm
    di, nh, g = spec.d_inner(d), spec.n_heads(d), spec.n_groups
    conv = di + 2 * g * spec.d_state
    return d + d * (2 * di + 2 * g * spec.d_state + nh) + conv * (spec.d_conv + 1) + 3 * nh \
        + di + di * d


def published_shared_params(cfg: ArchConfig) -> int:
    """The shared blocks of the published Zamba2 layout (`SharedBlocksSpec`)
    and each use's adapter and output Linear."""
    d, dh, hq, hkv, f = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    h = cfg.hybrid
    block = 2 * d + (2 * d) * (hq + 2 * hkv) * dh + hq * dh * d + d + d * 2 * f + f * d
    use = h.adapter_rank * (d + 2 * f) + d * d
    return h.n_blocks * block + len(h.layer_ids) * use
