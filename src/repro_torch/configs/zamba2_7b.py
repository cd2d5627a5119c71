"""zamba2-7b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242; unverified].

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Shared attention block applied every 6 layers on concat(x, x_embed).
Sub-quadratic backbone — runs the long_500k cell.
"""

import dataclasses

from repro_torch.models.config import ArchConfig, HybridSpec, SSMSpec

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
