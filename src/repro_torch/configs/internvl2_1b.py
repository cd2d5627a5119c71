"""internvl2-1b [vlm] — InternViT + InternLM2 [arXiv:2404.16821; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  The InternViT
frontend is a STUB: input_specs provides 256 precomputed 1024-dim patch
embeddings per sample, prepended to the text sequence.
"""

import dataclasses

from repro_torch.models.config import ArchConfig, DRFrontendSpec

CONFIG = ArchConfig(
    name="internvl2-1b", family="transformer",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151655,
    frontend="vision", frontend_dim=1024, frontend_seq=256,
)

CONFIG_DR = dataclasses.replace(
    CONFIG, dr_frontend=DRFrontendSpec(kind="rp_easi", p=512, n=256))

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=2, n_kv_heads=1,
    d_ff=128, vocab_size=512, frontend_dim=48, frontend_seq=8,
    q_chunk=32, kv_chunk=32,
)
