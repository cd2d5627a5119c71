"""The Zamba2 family at its published layout (Zyphra's Zamba2-7B-Instruct,
HF `model_type` zamba2): its sizes, its parameter leaves in the port's dict
layout and its operations, as `families/__init__.py` lists them.

A Mamba-2 backbone (B and C in `n_groups` groups, the output gated before
a norm over each group) with `n_blocks` shared attention + MLP blocks used
in alternation at `hybrid_layer_ids`, each use with its own adapter on the
MLP's gate_up and its own d × d output Linear; the shared block reads
cat(x, x0), x0 the token embedding, and its output feeds the next Mamba
layer's input.  Text only.

Weights from the seed: N(0, 1/d_in) for a product, the output projections
at 1/sqrt(2·L·d_in), ones for the norms and D; A = −exp(a_log) and the dt
bias drawn N(0, 1) and N(0, 9), so the heads' memories range from one
position to thousands; the conv's taps N(0, 1/K) and bias N(0, 0.01).

`ablate` is the benchmark's own field (absent from a config file, never
passed to the program): a mechanism the reference leaves out while the
weights and the program stay as they are ("adapters": no adapter,
"block0": block 0 at every use, "one_group": every SSD head reads group
0's B and C, "norm_then_gate": the group norm before the gate), planted as
an `arch_overrides` fault.  The program, which computes each one, then
fails the check by as much as a program without it would against the
whole reference: the check sees each mechanism.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

from portbench.flops import BF16, F32, PEAK_BF16_FLOPS, bound_s


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
    head_dim: int                 # the shared attention's head, on the 2·d concat
    rope_theta: float
    act: str                      # "gelu_erf": the exact GELU
    norm_eps: float
    tie_embeddings: bool
    param_dtype: str
    compute_dtype: str
    vocab_pad_to: int
    q_chunk: int
    kv_chunk: int
    # Mamba-2
    d_state: int
    d_conv: int
    expand: int
    ssm_head_dim: int
    n_groups: int
    # the shared blocks; their attention scaled by (head_dim / 2)^-1/2
    hybrid_layer_ids: Tuple[int, ...]
    n_blocks: int
    adapter_rank: int
    dr_frontend: Any = None
    ablate: Tuple[str, ...] = ()
    causal: bool = True
    frontend: Optional[str] = None
    frontend_dim: int = 0
    frontend_seq: int = 0

    @property
    def dh(self) -> int:
        return self.head_dim

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return -(-self.vocab_size // m) * m

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def sizes(fields, dr) -> Arch:
    if dr is not None:
        raise ValueError(f"{fields['name']}: the Zamba2 family takes no DR front end")
    f = dict(fields)
    f["hybrid_layer_ids"] = tuple(f["hybrid_layer_ids"])
    f["ablate"] = tuple(f.get("ablate", ()))
    return Arch(**f)


def port_config(a: Arch):
    """The port's `ArchConfig` of the same sizes (its published-layout specs)."""
    from repro_torch.models.config import ArchConfig, GroupedSSMSpec, SharedBlocksSpec

    return ArchConfig(
        name=a.name, family="zamba", n_layers=a.n_layers, d_model=a.d_model, d_ff=a.d_ff,
        vocab_size=a.vocab_size, n_heads=a.n_heads, n_kv_heads=a.n_kv_heads,
        head_dim=a.head_dim, rope_theta=a.rope_theta,
        ssm=GroupedSSMSpec(d_state=a.d_state, d_conv=a.d_conv, expand=a.expand,
                           head_dim=a.ssm_head_dim, n_groups=a.n_groups),
        hybrid=SharedBlocksSpec(layer_ids=a.hybrid_layer_ids, n_blocks=a.n_blocks,
                                adapter_rank=a.adapter_rank),
        act=a.act, norm_eps=a.norm_eps, tie_embeddings=a.tie_embeddings,
        param_dtype=a.param_dtype, compute_dtype=a.compute_dtype, vocab_pad_to=a.vocab_pad_to,
        q_chunk=a.q_chunk, kv_chunk=a.kv_chunk)


def leaf_specs(a: Arch) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(path, shape, scale) of every parameter leaf in the port's layout
    (`repro_torch.models.ssm`'s published section); a scale of 0 marks
    ones."""
    d, dh, hq, hkv, f = a.d_model, a.dh, a.n_heads, a.n_kv_heads, a.d_ff
    n_l, di, nh, c = a.n_layers, a.d_inner, a.ssm_heads, a.conv_channels
    nb, nu, r = a.n_blocks, len(a.hybrid_layer_ids), a.adapter_rank
    v = a.padded_vocab
    out = [("embed", (v, d), 1.0),
           ("final_norm", (d,), 0.0),
           ("layers/ln", (n_l, d), 0.0),
           ("layers/in_proj", (n_l, d, 2 * di + 2 * a.n_groups * a.d_state + nh),
            1.0 / math.sqrt(d)),
           ("layers/conv_w", (n_l, a.d_conv, 1, c), 1.0 / math.sqrt(a.d_conv)),
           ("layers/conv_b", (n_l, c), 0.1),
           ("layers/a_log", (n_l, nh), 1.0),
           ("layers/d_skip", (n_l, nh), 0.0),
           ("layers/dt_bias", (n_l, nh), 3.0),
           ("layers/norm_y", (n_l, di), 0.0),
           ("layers/out_proj", (n_l, di, d), 1.0 / math.sqrt(2 * n_l * di)),
           ("shared/ln1", (nb, 2 * d), 0.0),
           ("shared/wq", (nb, 2 * d, hq * dh), 1.0 / math.sqrt(2 * d)),
           ("shared/wk", (nb, 2 * d, hkv * dh), 1.0 / math.sqrt(2 * d)),
           ("shared/wv", (nb, 2 * d, hkv * dh), 1.0 / math.sqrt(2 * d)),
           ("shared/wo", (nb, hq * dh, d), 1.0 / math.sqrt(hq * dh)),
           ("shared/ln2", (nb, d), 0.0),
           ("shared/w_gate_up", (nb, d, 2 * f), 1.0 / math.sqrt(d)),
           ("shared/w_out", (nb, f, d), 1.0 / math.sqrt(f)),
           ("hybrid/adapter_a", (nu, d, r), 1.0 / math.sqrt(d)),
           ("hybrid/adapter_b", (nu, r, 2 * f), 1.0 / math.sqrt(r)),
           ("hybrid/proj", (nu, d, d), 1.0 / math.sqrt(d))]
    if not a.tie_embeddings:
        out.append(("lm_head", (d, v), 1.0 / math.sqrt(d)))
    return sorted(out)


def product_params(a: Arch) -> Tuple[int, int]:
    """(weights a token meets in one Mamba layer's products, in one use of a
    shared block's products)."""
    d, dh, hq, hkv, f, di, r = (a.d_model, a.dh, a.n_heads, a.n_kv_heads, a.d_ff, a.d_inner,
                                a.adapter_rank)
    mamba = d * (2 * di + 2 * a.n_groups * a.d_state + a.ssm_heads) + di * d
    use = 2 * d * (hq + 2 * hkv) * dh + hq * dh * d + d * 2 * f + r * (d + 2 * f) + f * d + d * d
    return mamba, use


def ssd_flops(a: Arch) -> float:
    """The SSD a position and layer as its recurrence needs it: the state's
    update (decay, dt·x·Bᵀ) and its readout (state·C), 4 · heads · Dh ·
    d_state.  A chunked form does more."""
    return 4.0 * a.ssm_heads * a.ssm_head_dim * a.d_state


def _per_token(a: Arch) -> float:
    mamba, use = product_params(a)
    return 2.0 * (a.n_layers * mamba + len(a.hybrid_layer_ids) * use) + a.n_layers * ssd_flops(a)


def _attention(a: Arch, batch: int, s: int) -> float:
    """Causal attention of every use: 4 · pairs · Dh a head."""
    return 4.0 * batch * (s * (s + 1) / 2) * a.n_heads * a.dh * len(a.hybrid_layer_ids)


def prefill_flops(a: Arch, batch: int, s: int, prefix_rows: int) -> float:
    """One prefill of `batch` streams of s tokens: every layer's and use's
    products, the SSD, causal attention; the head on the last position."""
    return batch * s * _per_token(a) + 2.0 * a.d_model * a.padded_vocab * batch + \
        _attention(a, batch, s)


def decode_flops(a: Arch, batch: int, s: int, steps: int) -> float:
    """`steps` decode steps after a prompt of s: each step one position
    through every layer, use and the head, its query scoring every key in
    the use's cache, its own included."""
    keys = steps * s + steps * (steps + 1) / 2
    f = (_per_token(a) + 2.0 * a.d_model * a.padded_vocab) * batch * steps
    return f + 4.0 * batch * keys * a.n_heads * a.dh * len(a.hybrid_layer_ids)


def flash_bound_s(a: Arch, batch: int, s: int, lse: bool) -> float:
    """B4 on one use: q, k, v read and the output written in bf16 (each
    row's log-sum-exp in f32 where a training forward writes it), causal
    pairs at the bf16 peak."""
    q = batch * s * a.n_heads * a.dh
    kv = 2 * batch * s * a.n_kv_heads * a.dh
    nbytes = BF16 * (2 * q + kv) + (F32 * batch * s * a.n_heads if lse else 0)
    return bound_s(4.0 * batch * (s * (s + 1) / 2) * a.n_heads * a.dh, nbytes, PEAK_BF16_FLOPS)
