"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m", family="transformer",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab_size=49152,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=96, n_heads=3, n_kv_heads=1,
    d_ff=256, vocab_size=256, q_chunk=32, kv_chunk=32,
)
