"""The traffic generator: every input of a run, drawn on its device from the
run's seed.

A frozen copy of the construction in `repro_torch/data/synthetic.py`,
moved onto the device so that set-up makes its inputs in a few large calls:
token streams follow a per-sequence random congruence over a small state
space, spread over the vocabulary, so the loss is not flat; continuous
features are a static random low-rank mixing of Laplace sources plus a
little noise, so the DR front end has structure to find.  Each draw takes
a generator of its own, seeded from (run seed, stream name, index) through
`numpy.random.SeedSequence`, so any seed (more than 32 bits included)
gives the same inputs on every run, and the reference can draw any one
input again without the others.
"""

from __future__ import annotations

import zlib
from typing import Dict, Optional

import numpy as np
import torch

N_STATES = 64        # synthetic.TokenStreamConfig.n_states


def generator(seed: int, stream: str, index: int, device) -> torch.Generator:
    """A generator on `device` for draw `index` of `stream` under `seed`."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32, zlib.crc32(stream.encode()), int(index)]
    state = np.random.SeedSequence(words).generate_state(2, dtype=np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) | (int(state[1] & 0x7FFFFFFF) << 32))
    return g


def tokens(g: torch.Generator, n_seq: int, seq_len: int, vocab: int) -> torch.Tensor:
    """(n_seq, seq_len) int32 token ids below `vocab`."""
    dev = g.device
    state0 = torch.randint(0, N_STATES, (n_seq, 1), generator=g, device=dev)
    mult = torch.randint(1, N_STATES, (n_seq, 1), generator=g, device=dev) * 2 + 1
    add = torch.randint(0, N_STATES, (n_seq, 1), generator=g, device=dev)
    idx = torch.arange(seq_len, device=dev)[None, :]
    states = (state0 + mult * idx + add * idx * idx) % N_STATES
    per = max(1, vocab // N_STATES)
    spread = torch.randint(0, per, (n_seq, seq_len), generator=g, device=dev)
    return ((states * per + spread) % vocab).to(torch.int32)


def mixing(seed: int, n_features: int, device) -> torch.Tensor:
    """The static mixing matrix (n_features, k) of a seed's feature stream."""
    g = generator(seed, "mixing", 0, device)
    k = max(2, n_features // 4)
    return torch.randn((n_features, k), generator=g, device=device)


def features(g: torch.Generator, a: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, n_features) f32: Laplace sources (rows, k) mixed by `a`, plus
    noise at 0.1."""
    dev = g.device
    k = a.shape[1]
    mag = torch.empty((rows, k), device=dev).exponential_(generator=g)
    sign = torch.randint(0, 2, (rows, k), generator=g, device=dev) * 2 - 1
    noise = torch.randn((rows, a.shape[0]), generator=g, device=dev)
    return (mag * sign) @ a.T + 0.1 * noise


def train_batch(seed: int, index: int, traffic: Dict, arch, a: Optional[torch.Tensor],
                device) -> Dict[str, torch.Tensor]:
    """Training batch `index`: `tokens` (B, S) and, for an audio front end,
    `frames` (B, S, f); for a vision one, `patches` (B, P, f); a text
    model's batch is its tokens alone (`a` None)."""
    b, s = traffic["batch"], traffic["seq"]
    g = generator(seed, "train", index, device)
    out = {"tokens": tokens(g, b, s, arch.vocab_size)}
    if arch.frontend == "audio":
        out["frames"] = features(g, a, b * s).reshape(b, s, arch.frontend_dim)
    elif arch.frontend == "vision":
        p = arch.frontend_seq
        out["patches"] = features(g, a, b * p).reshape(b, p, arch.frontend_dim)
    return out


def request(seed: int, index: int, traffic: Dict, arch, a: Optional[torch.Tensor],
            device) -> Dict[str, torch.Tensor]:
    """Serving request `index`: where the traffic has front-end rows,
    `rows` (sequences × prefix rows, f) of front-end features at unit
    variance a feature, as the DR stage takes them (a Laplace source has
    variance 2), and, where it has text, `tokens` (sequences, text tokens);
    a text model's request is its tokens alone (`a` None)."""
    n = traffic["sequences"]
    g = generator(seed, "request", index, device)
    out = {}
    if traffic.get("prefix_rows"):
        scale = (2.0 * a.shape[1] + 0.01) ** -0.5
        out["rows"] = features(g, a, n * traffic["prefix_rows"]) * scale
    if traffic.get("text_tokens"):
        out["tokens"] = tokens(g, n, traffic["text_tokens"], arch.vocab_size)
    return out


def continuation(seed: int, index: int, traffic: Dict, arch, device) -> torch.Tensor:
    """(sequences, decode steps) tokens that stand for what request `index`
    decodes, where a check reads logits along given tokens without a
    program to decode them (the control)."""
    g = generator(seed, "continuation", index, device)
    return tokens(g, traffic["sequences"], traffic["decode_steps"], arch.vocab_size)
