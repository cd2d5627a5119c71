"""The plain reference of the benchmark's Zamba2 configurations: plain
PyTorch in float32 with TF32 off, written from Zamba2's published equations
(HF `modeling_zamba2.py`), with no kernel, cache or chunked scan of the
program's.

Model, with x0 the token embedding and i = 0 … L − 1: where layer i is the
j-th of `hybrid_layer_ids`, block b = j mod `n_blocks` runs on
h = RMS(cat(x, x0)): causal softmax attention of its heads (RoPE on the two
halves of each head, the scores scaled by (Dh / 2)^-1/2), then
g = RMS(attn · Wo), gu = g · W_gate_up + (g · A_j) · B_j, T = (GELU(gu's
first half) ⊙ gu's second half) · W_out (GELU exact, by erf), and
u = x + T · P_j; elsewhere u = x.  Then x ← x + Mamba_i(RMS(u)).  A final
RMS norm and the head (the embedding, tied, unless the weights hold an
`lm_head`).

Mamba_i: `in_proj` gives [z | x | B | C | dt]; x | B | C through a causal
depthwise conv of width K with bias, then SiLU; dt = softplus(dt + dt_bias),
A = −exp(a_log); head h reads B and C of group h // (heads / groups).  The
SSM is computed in its quadratic dual form, in blocks of query positions:

    y_t = Σ_{s ≤ t} (C_t · B_s) · exp(ℓ_t − ℓ_s) · dt_s · x_s + D · x_t,
    ℓ = cumsum(dt · A)

with ℓ and its differences in float64, so that a long prompt's ℓ of
thousands loses nothing to cancellation.  Then y · SiLU(z), an RMS norm over
each group of d_inner / groups channels, times its weight, and `out_proj`.
`ssd_recurrent` is the same SSM as the step recurrence, for the tests.

Departures from `modeling_zamba2.py`, each a reading the config leaves
open or a simplification with the same value: no dropout, no biases (the
config's `add_bias_linear` false; the conv's bias kept); `time_step_limit`
null, so dt is not clamped; RoPE on the whole head (`use_mem_rope`), as the
port applies it; no attention adapter (`use_shared_attention_adapter`
false); the cache and the chunked scan (`chunk_size`) are not modelled, the
dual form being the same sum.

`Precision` as the transformer's reference: each product's inputs in f32,
TF32 or fp8, so the same code is the control one step of precision below
the configuration.  The sizes' `ablate` (the family's fault field) leaves
the mechanisms it names out.  Sizes come in as a plain object with the fields of
`portbench/families/zamba.py`'s `Arch`; weights as the nested dict the
benchmark drew.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .transformer import Precision, mm, rms_norm, rope, strict_f32  # noqa: F401

Q_BLOCK = 512           # query positions a block of the dual form and of attention


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def attention(q, k, v, scale: float, mode: str) -> torch.Tensor:
    """Causal softmax attention in blocks of query rows, q (B, S, Hq, Dh),
    k / v (B, S, Hkv, Dh)."""
    b, s, hq, _ = q.shape
    g = hq // k.shape[2]
    qh = q.permute(0, 2, 1, 3)
    kh = k.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vh = v.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    out = []
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(s, q0 + Q_BLOCK)
        sc = mm(qh[:, :, q0:q1], kh[:, :, :q1].transpose(-1, -2), mode) * scale
        hide = torch.arange(q1, device=q.device)[None, :] > \
            torch.arange(q0, q1, device=q.device)[:, None]
        out.append(mm(torch.softmax(sc.masked_fill(hide, float("-inf")), dim=-1),
                      vh[:, :, :q1], mode))
    return torch.cat(out, dim=2).permute(0, 2, 1, 3)


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x (B, S, C), w (K, 1, C): y_t = Σ_j w_j x_{t−K+1+j}
    + bias."""
    k, s = w.shape[0], x.shape[1]
    xin = torch.cat([torch.zeros_like(x[:, :k - 1]), x], dim=1)
    return sum(xin[:, j:j + s] * w[j, 0] for j in range(k)) + bias


def ssd_dual(x, dt, a, bmat, cmat, mode: str) -> torch.Tensor:
    """Σ_{s ≤ t} (C_t · B_s) exp(ℓ_t − ℓ_s) dt_s x_s: x (B, S, nh, dh),
    dt (B, S, nh), a (nh,), bmat / cmat (B, S, G, ds); ℓ in float64."""
    b, s, nh, _ = x.shape
    grp = nh // bmat.shape[2]
    ell = torch.cumsum(dt.double() * a.double(), dim=1).permute(0, 2, 1)   # (B, nh, S)
    xh = (x * dt[..., None]).permute(0, 2, 1, 3)                          # (B, nh, S, dh)
    bh = bmat.repeat_interleave(grp, dim=2).permute(0, 2, 3, 1)           # (B, nh, ds, S)
    ch = cmat.repeat_interleave(grp, dim=2).permute(0, 2, 1, 3)           # (B, nh, S, ds)
    out = []
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(s, q0 + Q_BLOCK)
        diff = ell[:, :, q0:q1, None] - ell[:, :, None, :q1]              # (B, nh, T, S')
        hide = torch.arange(q1, device=x.device)[None, :] > \
            torch.arange(q0, q1, device=x.device)[:, None]
        decay = torch.exp(diff.masked_fill(hide, -math.inf)).to(torch.float32)
        del diff
        w = mm(ch[:, :, q0:q1], bh[:, :, :, :q1], mode) * decay
        del decay
        out.append(mm(w, xh[:, :, :q1], mode))
    return torch.cat(out, dim=2).permute(0, 2, 1, 3)


def ssd_recurrent(x, dt, a, bmat, cmat, state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same SSM as the step recurrence, state ← exp(dt·A) state + dt x Bᵀ,
    y = state C: (y (B, S, nh, dh), final state (B, nh, dh, ds))."""
    b, s, nh, dh = x.shape
    grp = nh // bmat.shape[2]
    bh = bmat.repeat_interleave(grp, dim=2)
    ch = cmat.repeat_interleave(grp, dim=2)
    if state is None:
        state = torch.zeros((b, nh, dh, bmat.shape[-1]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)                                    # (B, nh)
        state = state * decay[..., None, None] + \
            (dt[:, t, :, None] * x[:, t])[..., None] * bh[:, t, :, None, :]
        ys.append((state @ ch[:, t, :, :, None])[..., 0])
    return torch.stack(ys, dim=1), state


def final_state(x, dt, a, bmat) -> torch.Tensor:
    """The SSM's state after the last position, Σ_s exp(ℓ_S − ℓ_s) dt_s x_s
    B_sᵀ: (B, nh, dh, ds)."""
    grp = x.shape[2] // bmat.shape[2]
    ell = torch.cumsum(dt.double() * a.double(), dim=1)                   # (B, S, nh)
    w = (torch.exp(ell[:, -1:] - ell).to(torch.float32) * dt)             # (B, S, nh)
    return torch.einsum("bsh,bshd,bshn->bhdn", w, x, bmat.repeat_interleave(grp, dim=2))


def mamba(lp: Dict[str, torch.Tensor], u: torch.Tensor, a, mode: str,
          states: Optional[Dict] = None) -> torch.Tensor:
    """Mamba_i(RMS(u)), the mixer's output (no residual).  `states` gathers
    the layer's final SSM state ("ssm") and its conv's last K − 1 inputs
    ("conv"), what a decode carries on from."""
    b, s, _ = u.shape
    di, nh, ds, g, ablate = a.d_inner, a.ssm_heads, a.d_state, a.n_groups, a.ablate
    h = rms_norm(u, lp["ln"], a.norm_eps)
    z, xbc, dt = torch.split(mm(h, lp["in_proj"], mode), [di, di + 2 * g * ds, nh], dim=-1)
    if states is not None:
        states.setdefault("conv", []).append(xbc[:, s - (a.d_conv - 1):])
    xbc = F.silu(causal_conv(xbc, lp["conv_w"], lp["conv_b"]))
    xs, bm, cm = torch.split(xbc, [di, g * ds, g * ds], dim=-1)
    bm, cm = bm.reshape(b, s, g, ds), cm.reshape(b, s, g, ds)
    if "one_group" in ablate:
        bm, cm = bm[:, :, :1].expand(-1, -1, g, -1), cm[:, :, :1].expand(-1, -1, g, -1)
    dt = F.softplus(dt + lp["dt_bias"])
    xh = xs.reshape(b, s, nh, a.ssm_head_dim)
    if states is not None:
        states.setdefault("ssm", []).append(final_state(xh, dt, -torch.exp(lp["a_log"]), bm))
    y = ssd_dual(xh, dt, -torch.exp(lp["a_log"]), bm, cm, mode) + lp["d_skip"][:, None] * xh
    y = y.reshape(b, s, di)
    gate = F.silu(z)
    if "norm_then_gate" not in ablate:
        y = y * gate
    y = rms_norm(y.reshape(b, s, g, di // g), 1.0, a.norm_eps).reshape(b, s, di)
    if "norm_then_gate" in ablate:
        y = y * gate
    return mm(y * lp["norm_y"], lp["out_proj"], mode)


def shared_block(sp, hp, x, x0, a, mode: str, states: Optional[Dict] = None
                 ) -> torch.Tensor:
    """T · P_j of one use: the block's attention and MLP on cat(x, x0);
    `states` gathers its roped keys ("k") and values ("v")."""
    b, s, _ = x.shape
    h = rms_norm(torch.cat([x, x0], dim=-1), sp["ln1"], a.norm_eps)
    q = rope(mm(h, sp["wq"], mode).reshape(b, s, a.n_heads, a.dh), a.rope_theta)
    k = rope(mm(h, sp["wk"], mode).reshape(b, s, a.n_kv_heads, a.dh), a.rope_theta)
    v = mm(h, sp["wv"], mode).reshape(b, s, a.n_kv_heads, a.dh)
    if states is not None:
        states.setdefault("k", []).append(k)
        states.setdefault("v", []).append(v)
    o = attention(q, k, v, 1.0 / math.sqrt(a.dh / 2), mode)
    g = rms_norm(mm(o.reshape(b, s, -1), sp["wo"], mode), sp["ln2"], a.norm_eps)
    gu = mm(g, sp["w_gate_up"], mode)
    if "adapters" not in a.ablate:
        gu = gu + mm(mm(g, hp["adapter_a"], mode), hp["adapter_b"], mode)
    f = a.d_ff
    t = mm(gelu_erf(gu[..., :f]) * gu[..., f:], sp["w_out"], mode)
    return mm(t, hp["proj"], mode)


def hidden(params, a, tokens: torch.Tensor, mode: str,
           states: Optional[Dict] = None) -> torch.Tensor:
    """The final normed hidden states of the token stream; `states`, a
    dict, gathers each layer's and use's state (`prefill_states`)."""
    f32 = torch.float32
    x = params["embed"].to(f32)[tokens.long()]
    x0 = x
    uses = {lid: j for j, lid in enumerate(a.hybrid_layer_ids)}
    for i in range(a.n_layers):
        u = x
        if i in uses:
            j = uses[i]
            blk = 0 if "block0" in a.ablate else j % a.n_blocks
            sp = {k: t[blk].to(f32) for k, t in params["shared"].items()}
            hp = {k: t[j].to(f32) for k, t in params["hybrid"].items()}
            u = x + shared_block(sp, hp, x, x0, a, mode, states)
        lp = {k: t[i].to(f32) for k, t in params["layers"].items()}
        x = x + mamba(lp, u, a, mode, states)
    return rms_norm(x, params["final_norm"].to(f32), a.norm_eps)


def head(params) -> torch.Tensor:
    return params["lm_head"] if "lm_head" in params else params["embed"].T


def last_logits(params, a, feats, tokens, mode: str) -> torch.Tensor:
    """(B, V) float32 logits of the last position."""
    with torch.no_grad():
        x = hidden(params, a, tokens, mode)
        return mm(x[:, -1], head(params), mode)


def stream_logits(params, a, feats, tokens, start: int, mode: str) -> torch.Tensor:
    """(B, S − start, V) float32 logits of positions start … S − 1, in one
    forward pass over the prompt and the tokens a decode fed after it."""
    with torch.no_grad():
        x = hidden(params, a, tokens, mode)
        return mm(x[:, start:], head(params), mode)


def prefill_states(params, a, tokens, mode: str) -> Dict[str, torch.Tensor]:
    """What a prompt leaves for a decode, stacked as the program's cache
    holds it: "ssm" (L, B, nh, dh, ds), "conv" (L, B, K − 1, channels),
    "k" / "v" (uses, B, S, K/V heads, Dh)."""
    states: Dict = {}
    with torch.no_grad():
        hidden(params, a, tokens, mode, states=states)
    return {k: torch.stack(v) for k, v in states.items()}
