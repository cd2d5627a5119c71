"""Deterministic, restart-safe synthetic data streams for LM-scale runs.

The JAX package's `data/synthetic.py`, with numpy as the source of every
draw: a batch is a pure function of (seed, step, shard) through
`numpy.random.SeedSequence([seed, step, shard])`, so a job that restarts
from a checkpoint at step k regenerates exactly the batches it would have
seen, and the port's batches equal the reference's bit for bit.  Batches
are CPU tensors; the train step moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # Markov-ish structure so losses are non-trivial (pure uniform tokens give
    # a flat loss surface and hide optimizer bugs).
    n_states: int = 64


def token_batch(cfg: TokenStreamConfig, step: int, *, shard: int = 0, n_shards: int = 1) -> dict:
    """{"tokens": (local batch, seq_len) int32, "step": int32 scalar} for
    `step`, restricted to data-parallel shard `shard`."""
    if cfg.global_batch % n_shards != 0:
        raise ValueError(f"global batch {cfg.global_batch} is not a multiple of {n_shards} shards")
    local = cfg.global_batch // n_shards
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, shard]))
    # Cheap structured stream: tokens follow a per-sequence random linear
    # congruence over a small state space, embedded into the full vocab.
    state0 = rng.integers(0, cfg.n_states, size=(local, 1))
    mult = rng.integers(1, cfg.n_states, size=(local, 1)) * 2 + 1
    add = rng.integers(0, cfg.n_states, size=(local, 1))
    idx = np.arange(cfg.seq_len)[None, :]
    states = (state0 + mult * idx + add * (idx ** 2)) % cfg.n_states
    spread = rng.integers(0, max(1, cfg.vocab_size // cfg.n_states), size=(local, cfg.seq_len))
    tokens = (states * max(1, cfg.vocab_size // cfg.n_states) + spread) % cfg.vocab_size
    return {"tokens": torch.from_numpy(tokens.astype(np.int32)),
            "step": torch.tensor(step, dtype=torch.int32)}


def feature_batch(n_features: int, batch: int, step: int, seed: int = 0, *, shard: int = 0,
                  n_shards: int = 1) -> torch.Tensor:
    """Continuous feature stream (batch // n_shards, n_features) f32, for DR
    front-end training; the same contract."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, shard, 7]))
    local = batch // n_shards
    # Correlated features: random low-rank mixing of independent sources so
    # that DR (whitening/ICA) has real structure to find.
    k = max(2, n_features // 4)
    s = rng.laplace(size=(local, k))
    a = np.random.default_rng(seed).standard_normal((n_features, k))  # static mixing
    x = s @ a.T + 0.1 * rng.standard_normal((local, n_features))
    return torch.from_numpy(x.astype(np.float32))


def stream(cfg: TokenStreamConfig, start_step: int = 0, *, shard: int = 0,
           n_shards: int = 1) -> Iterator[dict]:
    step = start_step
    while True:
        yield token_batch(cfg, step, shard=shard, n_shards=n_shards)
        step += 1
