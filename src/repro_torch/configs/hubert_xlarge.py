"""hubert-xlarge [audio] — encoder-only, w2v2 arch [arXiv:2106.07447; unverified].

48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504 (masked-unit targets).
Encoder-only: no decode cells.  The conv waveform stem is a STUB —
input_specs provides precomputed 512-dim frame embeddings, per assignment.
"""

import dataclasses

from repro_torch.models.config import ArchConfig, DRFrontendSpec

CONFIG = ArchConfig(
    name="hubert-xlarge", family="transformer",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504, act="gelu",
    causal=False,                 # encoder-only
    frontend="audio", frontend_dim=512,
)

# The paper's technique applied exactly as designed: DR on input features.
CONFIG_DR = dataclasses.replace(
    CONFIG, dr_frontend=DRFrontendSpec(kind="rp_easi", p=256, n=128))

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=64, frontend_dim=32, q_chunk=32, kv_chunk=32,
)
