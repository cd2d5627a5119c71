"""rwkv6-1.6b [ssm] — Finch, data-dependent decay [arXiv:2404.05892; unverified].

24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.  O(1) decode state —
runs the long_500k cell.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="rwkv6",
    n_layers=24, d_model=2048, d_ff=7168, vocab_size=65536,
    train_grad_accum=2,   # recurrence residual stacks: 19.4 -> 9.8 GB/dev
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, d_ff=256, vocab_size=256,
)
