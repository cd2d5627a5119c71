"""Waveform Database Generator V2 (paper §V-A; Breiman et al. 1984, UCI).

Re-implemented generator (no network access needed; the UCI file is itself
the output of this published generator):

  * 3 triangular base waves on t = 1..21:
        h1 peaks at t=7, h2 at t=15, h3 at t=11   (height 6)
  * class c ∈ {0,1,2} mixes two of the three with u ~ U(0,1):
        c=0: u·h1 + (1−u)·h2
        c=1: u·h1 + (1−u)·h3
        c=2: u·h2 + (1−u)·h3
  * every one of the 21 attributes gets N(0,1) noise
  * V2 appends 19 pure-noise N(0,1) attributes  → 40 features total

Paper protocol: drop the LAST 8 features (40 → 32, leaving 21 wave + 11
noise), 5000 samples, first 4000 train / last 1000 test, 3-way classification.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

N_WAVE_FEATURES = 21
N_NOISE_FEATURES = 19
N_TOTAL = N_WAVE_FEATURES + N_NOISE_FEATURES  # 40
PAPER_N_FEATURES = 32                          # after dropping the last 8


def _base_waves() -> np.ndarray:
    t = np.arange(1, N_WAVE_FEATURES + 1, dtype=np.float64)
    h1 = np.maximum(6.0 - np.abs(t - 7.0), 0.0)
    h2 = np.maximum(6.0 - np.abs(t - 15.0), 0.0)
    h3 = np.maximum(6.0 - np.abs(t - 11.0), 0.0)
    return np.stack([h1, h2, h3])  # (3, 21)


# class -> (wave_a, wave_b) indices into _base_waves()
_CLASS_MIX = {0: (0, 1), 1: (0, 2), 2: (1, 2)}


def generate(n_samples: int = 5000, seed: int = 0, n_features: int = N_TOTAL) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x (N, n_features) float32, y (N,) int32)."""
    rng = np.random.default_rng(seed)
    waves = _base_waves()
    y = rng.integers(0, 3, size=n_samples)
    u = rng.uniform(0.0, 1.0, size=(n_samples, 1))
    a = np.array([_CLASS_MIX[c][0] for c in y])
    b = np.array([_CLASS_MIX[c][1] for c in y])
    clean = u * waves[a] + (1.0 - u) * waves[b]            # (N, 21)
    noise = rng.standard_normal((n_samples, N_TOTAL))
    x = np.concatenate([clean, np.zeros((n_samples, N_NOISE_FEATURES))], axis=1) + noise
    if n_features < N_TOTAL:
        x = x[:, :n_features]                               # paper drops the tail
    return x.astype(np.float32), y.astype(np.int32)


def paper_split(seed: int = 0):
    """The exact paper protocol: 32 features, 4000 train / 1000 test."""
    x, y = generate(5000, seed=seed, n_features=PAPER_N_FEATURES)
    return (x[:4000], y[:4000]), (x[4000:], y[4000:])
