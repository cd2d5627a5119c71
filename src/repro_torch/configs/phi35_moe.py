"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2.
"""

import dataclasses

from repro_torch.models.config import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="transformer",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab_size=32064,
    moe=MoESpec(n_experts=16, top_k=2, d_ff_expert=6400),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab_size=256,
    moe=MoESpec(n_experts=4, top_k=2, d_ff_expert=96),
    q_chunk=32, kv_chunk=32,
)
