"""yi-6b [dense] — llama-arch GQA [arXiv:2403.04652; hf].

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="transformer",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab_size=64000,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab_size=256, q_chunk=32, kv_chunk=32,
)
