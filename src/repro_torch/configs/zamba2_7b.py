"""zamba2-7b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242; unverified].

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Shared attention block applied every 6 layers on concat(x, x_embed).
Sub-quadratic backbone — runs the long_500k cell.
"""

import dataclasses

from repro_torch.models.config import (ArchConfig, GroupedSSMSpec, HybridSpec, SharedBlocksSpec,
                                       SSMSpec)

CONFIG = ArchConfig(
    name="zamba2-7b", family="zamba",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    head_dim=112, d_ff=14336, vocab_size=32000,
    ssm=SSMSpec(d_state=64, d_conv=4, expand=2, head_dim=64),
    hybrid=HybridSpec(attn_every=6),
    train_grad_accum=2,   # 81-layer hybrid residual stacks: 22.5 -> 11.5 GB/dev
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab_size=256,
    ssm=SSMSpec(d_state=8, d_conv=4, expand=2, head_dim=16),
    hybrid=HybridSpec(attn_every=2), q_chunk=32, kv_chunk=32,
)

# Zamba2-7B-Instruct as published (huggingface.co/Zyphra/Zamba2-7B-Instruct,
# config.json): two shared blocks in alternation at `hybrid_layer_ids`, 32
# heads of `attention_head_dim` 224 on the 7168-wide concat, scores scaled by
# (224 / 2)^-1/2, an exact-GELU gate with a rank-128 adapter a use,
# `mamba_ngroups` 2 with the gate before the grouped norm, and the head
# tied to the embedding.  The port's own spec classes: the JAX package has
# no such layout.
PUBLISHED = dataclasses.replace(
    CONFIG, name="zamba2-7b-instruct", head_dim=224, act="gelu_erf", tie_embeddings=True,
    ssm=GroupedSSMSpec(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=2),
    hybrid=SharedBlocksSpec(layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
                            n_blocks=2, adapter_rank=128),
    train_grad_accum=1,
)
