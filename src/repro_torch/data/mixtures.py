"""Synthetic ICA ground-truth mixtures for validating EASI (§III-D).

x = A s with independent non-Gaussian sources s — lets tests measure the
Amari distance of the learned separator, which the paper's accuracy tables
only probe indirectly.

A copy of the JAX package's `data/mixtures.py` (numpy only), so the same
seed gives the same arrays bit for bit in both packages.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def sources(rng: np.random.Generator, n_samples: int, n_src: int, kinds=None) -> np.ndarray:
    """Independent, zero-mean, unit-variance, non-Gaussian sources."""
    kinds = kinds or ["laplace", "uniform", "bimodal", "sine"]
    cols = []
    for i in range(n_src):
        k = kinds[i % len(kinds)]
        if k == "laplace":
            s = rng.laplace(size=n_samples) / np.sqrt(2.0)
        elif k == "uniform":
            s = rng.uniform(-np.sqrt(3), np.sqrt(3), size=n_samples)
        elif k == "bimodal":
            s = rng.choice([-1.0, 1.0], size=n_samples) + 0.3 * rng.standard_normal(n_samples)
            s = (s - s.mean()) / s.std()
        else:  # deterministic-ish sine with random phase, sub-Gaussian
            t = np.arange(n_samples)
            s = np.sin(2 * np.pi * (0.013 + 0.007 * i) * t + rng.uniform(0, 2 * np.pi))
            s = s / s.std()
        cols.append(s)
    return np.stack(cols, axis=1)  # (N, n_src)


def mixture(
    n_samples: int = 20000, m: int = 8, n_src: int = 4, seed: int = 0, noise: float = 0.0,
    kinds=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x (N, m), A (m, n_src), s (N, n_src)); x = s Aᵀ (+ noise).

    Note on nonlinearity pairing: EASI with the paper's cubic g is the
    stable estimator for *sub-Gaussian* sources; pass
    kinds=["uniform","bimodal","sine"] for tight-recovery tests and include
    "laplace" to exercise the mixed-kurtosis (harder) regime.
    """
    rng = np.random.default_rng(seed)
    s = sources(rng, n_samples, n_src, kinds=kinds)
    a = rng.standard_normal((m, n_src))
    # Keep A well-conditioned so separation is identifiable.
    u, _, vt = np.linalg.svd(a, full_matrices=False)
    a = u @ vt + 0.1 * rng.standard_normal((m, n_src))
    x = s @ a.T
    if noise > 0:
        x = x + noise * rng.standard_normal(x.shape)
    return x.astype(np.float32), a.astype(np.float32), s.astype(np.float32)
