"""The paper's own experiment (§V): Waveform-V2, m=32 → {16, 8}.

The JAX package's `configs/waveform_paper.py`, over the port's stages: the
same rows, μ, blocks and epochs.  Rows are `repro_torch.dr.DRModel` stage
chains (the Table-I datapaths written out explicitly) with the default
`Execution` (torch backend, on the card); `pipeline.fit_two_stage(...,
execution=...)` picks another backend or device.  `dr_unit.from_legacy`
builds the same compositions from the historical `DRConfig(kind=...)`
spelling.

Locked Table-I reproduction protocol (see EXPERIMENTS.md §Paper-parity for
measured numbers and the init-sensitivity analysis):

  * preprocessing: centre + one global scalar scale (pipeline convention)
  * DR init: random row-orthonormal subspace for EVERY row of the table —
    rectangular EASI provably cannot rotate span(B₀) (easi.init_b doc), so
    init-matched comparisons are the only fair reading of the paper's
    "RP+EASI ≈ EASI" claim.  Eye/strided-init reference rows are included as
    ablations.
  * rp_easi rows use the paper's proposed bypassed (rotation-only) datapath;
    per-sample cubic updates are unstable on unwhitened RP output (documented
    divergence), so the bypassed rows use the block-averaged estimator
    (block=32) with μ=2e-4 — the TPU-adapted form of the same estimator.
  * full-EASI rows: per-sample (block=1), μ=1e-3, 3 epochs — paper-exact
    streaming.
"""

from __future__ import annotations

from repro_torch.core.pipeline import TwoStageConfig
from repro_torch.dr import DRModel, EASIStage, RPStage

M = 32  # paper drops the last 8 of 40 features


def easi_model(m: int, n: int, *, mu: float = 1e-3, block: int = 1,
               init: str = "orthonormal") -> DRModel:
    """Full-width EASI m → n (Table I rows 1/3)."""
    return DRModel(stages=(EASIStage.full(m, n, mu=mu, init_mode=init),),
                   block_size=block)


def rp_easi_model(m: int, p: int, n: int, *, mu: float = 2e-4, block: int = 32,
                  bypass_whitening: bool = True) -> DRModel:
    """THE PAPER'S PROPOSAL: RP m → p, then EASI p → n with the whitening
    term bypassed (rotation-only); `bypass_whitening=False` keeps Eq. 6's
    second-order term after RP (the Table I row 2/4 ablation)."""
    easi = (EASIStage.rotation(p, n, mu=mu) if bypass_whitening
            else EASIStage.full(p, n, mu=mu))
    return DRModel(stages=(RPStage(m, p), easi), block_size=block)


def rp_model(m: int, n: int) -> DRModel:
    """Pure static ternary projection (reference row)."""
    return DRModel(stages=(RPStage(m, n),))


def whiten_model(m: int, n: int, *, mu: float = 1e-3, block: int = 1) -> DRModel:
    """Adaptive PCA whitening (Eq. 3) reference row."""
    return DRModel(stages=(EASIStage.whiten(m, n, mu=mu),), block_size=block)


# ---- Table I rows (paper order) -------------------------------------------
TABLE1_ROWS = {
    # (Algorithm1, p, Algorithm2, n) -> config
    "easi_n16": TwoStageConfig(dr=easi_model(M, 16), dr_epochs=3),
    "rp24_easi_n16": TwoStageConfig(dr=rp_easi_model(M, 24, 16), dr_epochs=40),
    "easi_n8": TwoStageConfig(dr=easi_model(M, 8), dr_epochs=3),
    "rp16_easi_n8": TwoStageConfig(dr=rp_easi_model(M, 16, 8), dr_epochs=40),
}

PAPER_TABLE1 = {  # paper's reported accuracies (%)
    "easi_n16": 84.6,
    "rp24_easi_n16": 84.5,
    "easi_n8": 80.9,
    "rp16_easi_n8": 80.8,
}

# ---- ablation / reference rows ---------------------------------------------
ABLATION_ROWS = {
    "easi_n16_eyeinit": TwoStageConfig(dr=easi_model(M, 16, init="eye"), dr_epochs=3),
    "easi_n8_strided": TwoStageConfig(dr=easi_model(M, 8, init="strided"), dr_epochs=3),
    "rp24_easi_n16_fullEASI": TwoStageConfig(
        dr=rp_easi_model(M, 24, 16, mu=5e-4, block=1, bypass_whitening=False),
        dr_epochs=3),
    "rp_n16": TwoStageConfig(dr=rp_model(M, 16), dr_epochs=1),
    "rp_n8": TwoStageConfig(dr=rp_model(M, 8), dr_epochs=1),
    "whiten_n16": TwoStageConfig(dr=whiten_model(M, 16), dr_epochs=3),
}

# ---- deeper than the paper: a 3-stage cascade reference --------------------
# m → p₁ (static RP) → p₂ (whiten) → n (rotation): the kind enum could not
# express this; the stage API trains it end-to-end.
CASCADE_ROWS = {
    "rp24_whiten16_rot8": TwoStageConfig(
        dr=DRModel(stages=(RPStage(M, 24),
                           EASIStage.whiten(24, 16, mu=5e-4),
                           EASIStage.rotation(16, 8, mu=2e-4)),
                   block_size=32),
        dr_epochs=20),
}

# Table II configs (hardware-cost comparison): EASI 32->8 vs RP(16)+EASI 16->8
TABLE2_PAIR = {
    "easi_32_8": easi_model(32, 8, mu=5e-4),
    "rp16_easi_8": rp_easi_model(32, 16, 8, mu=5e-4),
}
