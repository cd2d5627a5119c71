"""h2o-danube-3-4b [dense] — llama+mistral mix, SWA [arXiv:2401.16818; unverified].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000; sliding-window
attention (mistral-style 4k window) bounds the decode cache, so this arch
runs the long_500k cell.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="transformer",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab_size=32000,
    sliding_window=4096,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab_size=256, sliding_window=16, q_chunk=32, kv_chunk=32,
)
