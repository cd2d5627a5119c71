"""Adaptive PCA whitening (paper §III-C, Eq. 3).

    z  = W x
    W ← W − μ [ z zᵀ − I ] W

This is the EASI datapath with the higher-order term muxed out, so the
implementation delegates to `repro_torch.core.easi` with `higher_order=False`.
"""

from __future__ import annotations

import torch

from repro_torch.core import easi


def whitening_config(m: int, n: int, mu: float = 1e-3, **kw) -> easi.EASIConfig:
    """EASIConfig specialised to Eq. 3 (second-order only)."""
    return easi.EASIConfig(m=m, n=n, mu=mu, second_order=True, higher_order=False, **kw)


def init_w(generator: torch.Generator, cfg: easi.EASIConfig) -> torch.Tensor:
    return easi.init_b(generator, cfg)


def whiten_fit(w0, x, cfg, *, block_size: int = 1, epochs: int = 1, execution=None):
    """Train W on x (N, m); returns W minimising KL(Σ_z ‖ I)."""
    if cfg.higher_order:
        raise ValueError("whitening must not carry the HOS term")
    return easi.easi_fit(w0, x, cfg, block_size=block_size, epochs=epochs,
                         execution=execution)


transform = easi.transform
whiteness_kl = easi.whiteness_kl
