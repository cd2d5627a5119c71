"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base; unverified].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
"""

import dataclasses

from repro_torch.models.config import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="dbrx-132b", family="transformer",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    moe=MoESpec(n_experts=16, top_k=4, d_ff_expert=10752),
    train_grad_accum=4,   # single-pod 132B train: activation temp must stay well under HBM
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab_size=256,
    moe=MoESpec(n_experts=4, top_k=2, d_ff_expert=96),
    q_chunk=32, kv_chunk=32,
)
