"""starcoder2-7b [dense] — GQA, RoPE [arXiv:2402.19173; hf].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152. GELU MLP.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b", family="transformer", gated_mlp=False,
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab_size=49152, act="gelu",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=72, n_heads=3, n_kv_heads=1,
    d_ff=160, vocab_size=256, q_chunk=32, kv_chunk=32,
)
