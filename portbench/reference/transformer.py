"""The plain reference of the benchmark's transformer configurations, with
the paper's RP → EASI front end: plain PyTorch in float32 with TF32 off,
written from the equations, with no kernel, cache or batching of the
program's.

Model: embeddings (audio frames or vision patches through the front-end
projection, vision patches put before the text tokens' embeddings; a text
model's tokens alone); each layer x += Wo·attn(RoPE(q), RoPE(k), v) on the
RMS-normed x (RoPE on causal models only, rotating the two halves of each
head), then x += W_out
(act(x W_gate) ⊙ x W_in) on the RMS-normed x; a final RMS norm and the
head.  Attention is a plain softmax over the scores, scaled by 1/√Dh, with
the K/V heads shared by groups of query heads.  The encoder's loss is the
mean NLL of the unit at every frame, a causal model's that of each next
text token; a decode is checked by one forward pass over the prompt and
the tokens it fed (`stream_logits`).  AdamW clips the gradient at a global
norm of 1.0 first.  The DR front end normalises each batch (centre, one
scale), projects by the ternary R at √(p/m), then multiplies by Bᵀ; its
update is the block EASI step, B ← B − μ G B.

`Precision` sets each product's inputs: "f32" (TF32 off), "tf32", or "fp8"
(each operand rounded to float8 e4m3 at a per-tensor scale, the products
then in float32), so the same code is the control one step of precision
below the configuration.  Sizes come in as a plain object with the fields
of `portbench/families/transformer.py`'s `Arch`; weights as the nested dict the benchmark
drew.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class Precision:
    lm: str = "f32"       # the model's products
    dr: str = "f32"       # the front end's products


FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 at a per-tensor scale; the gradient passes
    straight through the rounding."""
    s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return t + (q - t.detach())


def mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b in float32, its inputs as `mode` says."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    if mode == "fp8":
        a, b = _fp8(a), _fp8(b)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def strict_f32() -> None:
    """TF32 off for every product the reference does not set itself."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# the DR front end
# ---------------------------------------------------------------------------

def dr_normalize(x: torch.Tensor) -> torch.Tensor:
    """Centre each feature, then divide by one scale: the root of the mean
    per-feature variance (+1e-8)."""
    mean = x.mean(dim=0)
    c = x - mean
    scale = torch.sqrt(torch.mean(torch.mean(c * c, dim=0))) + 1e-8
    return c / scale


def rp(r: torch.Tensor, x: torch.Tensor, mode: str) -> torch.Tensor:
    """x (rows, m) through the ternary R (p, m) with s = p, scaled by √(s/m)."""
    p, m = r.shape
    return mm(x, r.to(torch.float32).T, mode) * math.sqrt(p / m)


def dr_transform(r: torch.Tensor, b: torch.Tensor, x: torch.Tensor, mode: str) -> torch.Tensor:
    return mm(rp(r, x, mode), b.T, mode)


def easi_update(r: torch.Tensor, b: torch.Tensor, x: torch.Tensor, mu: float,
                second_order: bool, mode: str) -> torch.Tensor:
    """One block EASI step on raw rows x (rows, m) with the cubic g:
    G = (g(y)ᵀy − yᵀg(y))/rows [+ yᵀy/rows − I], B − μ G B."""
    h = rp(r, x, mode)
    y = mm(h, b.T, mode)
    rows, n = y.shape
    gy = y * y * y
    hg = mm(gy.T, y, mode) / rows
    g = hg - hg.T
    if second_order:
        g = g + mm(y.T, y, mode) / rows - torch.eye(n, device=y.device)
    return b - mu * mm(g, b, mode)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh) rotated by position, the two halves of Dh paired."""
    s, dh = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, causal: bool, mode: str) -> torch.Tensor:
    """Softmax attention, q (B, S, Hq, Dh), k / v (B, S, Hkv, Dh)."""
    b, s, hq, dh = q.shape
    g = hq // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))        # (B, H, S, Dh)
    scores = mm(qh, kh.transpose(-1, -2), mode) / math.sqrt(dh)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(mask, float("-inf"))
    out = mm(torch.softmax(scores, dim=-1), vh, mode)
    return out.permute(0, 2, 1, 3)


def act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))
    if name == "silu":
        return x * torch.sigmoid(x)
    raise ValueError(f"unknown activation {name!r}")


def layer(lp: Dict[str, torch.Tensor], x: torch.Tensor, a, mode: str) -> torch.Tensor:
    b, s, d = x.shape
    h = rms_norm(x, lp["ln1"], a.norm_eps)
    q = mm(h, lp["wq"], mode).reshape(b, s, a.n_heads, a.dh)
    k = mm(h, lp["wk"], mode).reshape(b, s, a.n_kv_heads, a.dh)
    v = mm(h, lp["wv"], mode).reshape(b, s, a.n_kv_heads, a.dh)
    if a.causal:
        q, k = rope(q, a.rope_theta), rope(k, a.rope_theta)
    x = x + mm(attention(q, k, v, a.causal, mode).reshape(b, s, -1), lp["wo"], mode)
    h = rms_norm(x, lp["ln2"], a.norm_eps)
    y = act(a.act, mm(h, lp["w_gate"], mode)) * mm(h, lp["w_in"], mode) if a.gated_mlp \
        else act(a.act, mm(h, lp["w_in"], mode))
    return x + mm(y, lp["w_out"], mode)


def embed(params, a, feats: Optional[torch.Tensor], tokens: Optional[torch.Tensor], mode: str):
    """The stream (B, S, d): reduced front-end features (B, P, n) through the
    projection, before the tokens' embeddings for a vision model; the
    tokens' embeddings alone without a front end."""
    if a.frontend is None:
        return params["embed"].to(torch.float32)[tokens.long()]
    px = mm(feats, params["frontend_proj"], mode)
    if a.frontend == "audio":
        return px
    tx = params["embed"].to(torch.float32)[tokens.long()]
    return torch.cat([px, tx], dim=1)


def hidden(params, a, x: torch.Tensor, mode: str, remat: bool = False) -> torch.Tensor:
    """The final normed hidden states of the stream x."""
    # one unbind a leaf: its backward stacks the layers' gradients once
    per_leaf = {k: t.unbind(0) for k, t in params["layers"].items()}
    for i in range(a.n_layers):
        lp = {k: ts[i].to(torch.float32) for k, ts in per_leaf.items()}
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, lp, x, a, mode, use_reentrant=False)
        else:
            x = layer(lp, x, a, mode)
    return rms_norm(x, params["final_norm"].to(torch.float32), a.norm_eps)


def last_logits(params, a, feats, tokens, mode: str) -> torch.Tensor:
    """(B, V) float32 logits of the last position."""
    with torch.no_grad():
        x = hidden(params, a, embed(params, a, feats, tokens, mode), mode)
        return mm(x[:, -1], params["lm_head"], mode)


def stream_logits(params, a, feats, tokens, start: int, mode: str) -> torch.Tensor:
    """(B, S − start, V) float32 logits of positions start .. S − 1 of the
    whole stream, in one forward pass over it (a prompt and the tokens a
    decode fed after it, teacher-forced)."""
    with torch.no_grad():
        x = hidden(params, a, embed(params, a, feats, tokens, mode), mode)
        return mm(x[:, start:], params["lm_head"], mode)


def lm_loss(params, a, feats, tokens, mode: str) -> torch.Tensor:
    """Mean NLL of each text token from the position before it (past a
    vision model's patches), the head over the padded vocabulary."""
    x = hidden(params, a, embed(params, a, feats, tokens, mode), mode, remat=True)
    n_prefix = feats.shape[1] if a.frontend == "vision" else 0
    logits = mm(x[:, n_prefix:n_prefix + tokens.shape[1] - 1], params["lm_head"], mode)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1).long())


def encoder_loss(params, a, feats, tokens, mode: str) -> torch.Tensor:
    """Mean NLL of each frame's unit, the head over the padded vocabulary."""
    x = hidden(params, a, embed(params, a, feats, None, mode), mode, remat=True)
    logits = mm(x, params["lm_head"], mode)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens.reshape(-1).long())


# ---------------------------------------------------------------------------
# one training step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    clip: float = 1.0


def leaves(params) -> Dict[str, torch.Tensor]:
    """The parameter leaves by path (`layers/wq`)."""
    out = {}
    for k, t in params.items():
        if isinstance(t, dict):
            out.update({f"{k}/{kk}": tt for kk, tt in t.items()})
        else:
            out[k] = t
    return out


def train_step(params, opt: Dict, dr: Tuple[torch.Tensor, torch.Tensor], batch, a,
               prec: Precision, adam: AdamW = AdamW()):
    """One step in place on `params` (leaves requiring grad) and the AdamW
    state `opt` ({"t": int, "m": {path: t}, "v": {path: t}}); the DR unit
    reads its pre-step state in the loss, then takes one EASI step on the
    batch's first 4096 normalised rows.  The encoder's loss is every
    frame's unit, a causal model's the next text token.  Returns (loss,
    the clipped gradient's norm by path, the new B, None without a DR
    unit)."""
    r, b = dr
    spec = a.dr_frontend
    feats = None
    if spec is not None:
        raw = batch["frames" if a.frontend == "audio" else "patches"]
        nb, s, fd = raw.shape
        flat = dr_normalize(raw.reshape(nb * s, fd).to(torch.float32))
        with torch.no_grad():
            feats = dr_transform(r, b, flat, prec.dr).reshape(nb, s, -1)
    lv = leaves(params)
    loss = lm_loss(params, a, feats, batch["tokens"], prec.lm) if a.causal else \
        encoder_loss(params, a, feats, batch["tokens"], prec.lm)
    grads = torch.autograd.grad(loss, list(lv.values()), allow_unused=True,
                                materialize_grads=True)
    with torch.no_grad():
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(adam.clip / (norm + 1e-9), max=1.0)
        opt["t"] += 1
        t = opt["t"]
        clipped = {}
        for (path, p), g in zip(lv.items(), grads):
            g = g * scale
            clipped[path] = float(torch.linalg.vector_norm(g))
            m = opt["m"].setdefault(path, torch.zeros_like(p))
            v = opt["v"].setdefault(path, torch.zeros_like(p))
            m.mul_(adam.b1).add_((1 - adam.b1) * g)
            v.mul_(adam.b2).add_((1 - adam.b2) * g * g)
            mhat = m / (1 - adam.b1 ** t)
            vhat = v / (1 - adam.b2 ** t)
            p.sub_(adam.lr * mhat / (torch.sqrt(vhat) + adam.eps))
        b_new = None if spec is None else \
            easi_update(r, b, flat[:4096], spec.mu, not spec.bypass_whitening, prec.dr)
    return loss.detach(), clipped, b_new
