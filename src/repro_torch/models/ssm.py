"""Mamba-2 (SSD) blocks and the Zamba-2 hybrid.

The port of the JAX package's `models/ssm.py`: `init_params`, `loss_fn`
over `hidden_states` (each layer, shared block included, under checkpoint
with `remat`), `forward`, and the serving steps `init_cache`, `prefill`,
`decode_step`.  Zamba-2 is a Mamba-2 backbone with ONE shared attention + MLP
block applied every `attn_every` layers; the shared block reads
concat(x_layer, x_embed) (2·d_model).  The decode state is each layer's
SSD state and causal-conv inputs, plus one small KV cache per shared-block
slot.

Parameters are a plain dict with the reference's keys and its stacked
`[L, ...]` layout; the layer stack is a Python loop in place of
`lax.scan` (each layer's leaves cast to the compute dtype as it runs, so
no second whole-model copy exists), and the reference's mesh pins are
dropped: on a mesh each layer gathers its own leaves from the rank's
shards (`blocks.gather_layer`) and the shared block's K/V cache keeps its
slots split over "model" as the transformer's does.  The shared block's prefill attention goes through the flash
kernel when the `Execution` says `backend="kernel"`; its decode attention
and both SSD forms are plain PyTorch, as the reference's are jnp outside
any Pallas kernel.

`mamba_block` keeps both of the reference's forms and their rounding
points: the block form (Mamba-2's chunked algorithm) when the sequence is a
multiple of `SSD_CHUNK` longer than 1, the step recurrence otherwise
(decode, and prompts that are not a multiple).  The block form adds the
skip term in the compute dtype, the step form in f32 with one rounding.
When grad is needed the block form runs chunk by chunk, each chunk under
checkpoint as in the reference (`_ssd_chunk`); without grad it batches
every chunk's intra-chunk and carry-out terms (`_ssd_blocks`), the same
arithmetic in another order.  The backward is autograd through either
form.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.execution import Execution
from repro_torch.dist import sharding as shard_rules
from repro_torch.models import blocks
from repro_torch.models.transformer import cache_slots, prompt_slots
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]
SSD_CHUNK = 64  # block-form chunk length (tests may override)


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------

def _a_log(nh: int) -> torch.Tensor:
    """log(linspace(1, 16, nh)) in f32, each value rounded once from f64 (the
    reference's XLA log on the CPU may differ from it in the last bit)."""
    return torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float64)).to(torch.float32)


def mamba_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
               device: torch.device) -> Params:
    d = cfg.d_model
    spec = cfg.ssm
    di, nh, ds = spec.d_inner(d), spec.n_heads(d), spec.d_state
    conv_ch = di + 2 * ds

    def dense(d_in, d_out, scale=None):
        return blocks.dense_init(gen, d_in, d_out, dtype, scale).to(device)

    conv_w = torch.randn((spec.d_conv, 1, conv_ch), generator=gen, dtype=torch.float32,
                         device=gen.device) * 0.2
    return {
        "ln": torch.ones((d,), dtype=dtype, device=device),
        "in_proj": dense(d, 2 * di + 2 * ds + nh),
        "conv_w": conv_w.to(dtype).to(device),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "a_log": _a_log(nh).to(dtype=dtype, device=device),
        "d_skip": torch.ones((nh,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((nh,), dtype=dtype, device=device),
        "norm_y": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": dense(di, d, scale=1.0 / math.sqrt(2 * cfg.n_layers * di)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d, x (B, S, C), w (K, 1, C) -> (y, new state).

    The K taps are summed in f32 and rounded to x's dtype once, where XLA's
    depthwise `conv_general_dilated` rounds on the CPU
    (`tests/test_torch_recurrent.py` holds it).  The new state is the last
    K − 1 inputs (B, K − 1, C) in x's dtype."""
    k, s = w.shape[0], x.shape[1]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xin = torch.cat([pad, x], dim=1)
    xin32 = xin.to(torch.float32)
    w32 = w.to(x.dtype).to(torch.float32)
    y = xin32[:, 0:s] * w32[0, 0]
    for j in range(1, k):
        y = y + xin32[:, j:j + s] * w32[j, 0]
    y = y.to(x.dtype)
    return blocks.act_fn("silu")(y + b.to(x.dtype)), xin[:, -(k - 1):, :]


def _ssd_steps(xh, bmat, cmat, decay, dt, state):
    """The step recurrence: state ← decay·state + (x·dt) bᵀ, y = state c.
    xh (B, S, nh, dh), bmat / cmat (B, S, ds) in the compute dtype; decay, dt
    (B, S, nh) f32; state (B, nh, dh, ds) f32 (not written).  Returns (ys in
    xh's dtype, final state)."""
    s = xh.shape[1]
    xdt = xh.to(torch.float32) * dt[..., None]                 # (B, S, nh, dh)
    b32, c32 = bmat.to(torch.float32), cmat.to(torch.float32)
    ys = []
    for t in range(s):
        upd = xdt[:, t, :, :, None] * b32[:, t, None, None, :]  # (B, nh, dh, ds), exact
        state = state * decay[:, t, :, None, None] + upd
        ys.append((state @ c32[:, t, None, :, None])[..., 0].to(xh.dtype))
    return torch.stack(ys, dim=1), state


def _ssd_blocks(xh, bmat, cmat, dt, a, state):
    """Block-form SSD over chunks of SSD_CHUNK steps, with ℓ = cumsum(dt·a)
    per chunk (log-space, every exponent ≤ 0):
        intra:  y_t += Σ_{s≤t} (c_t·b_s)·exp(ℓ_t−ℓ_s)·dt_s·x_s
        carry:  y_t += (c_t·h_in)·exp(ℓ_t);  h_out = exp(ℓ_T)h_in + Σ_s …
    The intra-chunk terms and each chunk's carry-out contribution are
    batched over the chunks; only the carry runs chunk by chunk.  Shapes as
    `_ssd_steps`, a (nh,) f32.  Returns (ys in xh's dtype, final state)."""
    b, s, nh, dh = xh.shape
    ds = bmat.shape[-1]
    t_c = SSD_CHUNK
    nch = s // t_c
    lseg = torch.cumsum((dt * a).reshape(b, nch, t_c, nh), dim=2)      # (B, C, T, nh)
    xc32 = xh.to(torch.float32).reshape(b, nch, t_c, nh, dh)
    bc32 = bmat.to(torch.float32).reshape(b, nch, t_c, ds)
    cc32 = cmat.to(torch.float32).reshape(b, nch, t_c, ds)
    dtc = dt.reshape(b, nch, t_c, nh)
    # intra-chunk quasi-attention, heads ahead of (t, s): (B, C, nh, T, S)
    cb = cc32 @ bc32.transpose(-1, -2)                                 # (B, C, T, S)
    lh = lseg.permute(0, 1, 3, 2)                                      # (B, C, nh, T)
    causal = torch.ones((t_c, t_c), dtype=torch.bool, device=xh.device).tril()
    m = torch.exp(torch.where(causal, lh[..., :, None] - lh[..., None, :], -math.inf))
    m = m * cb[:, :, None]
    xdt = (xc32 * dtc[..., None]).permute(0, 1, 3, 2, 4)               # (B, C, nh, S, dh)
    y_intra = (m @ xdt).permute(0, 1, 3, 2, 4)                         # (B, C, T, nh, dh)
    # each chunk's carry-out contribution Σ_s exp(ℓ_T − ℓ_s)·dt_s·x_s b_sᵀ
    w_end = torch.exp(lseg[:, :, -1:, :] - lseg) * dtc                 # (B, C, S, nh)
    xw = (xc32 * w_end[..., None]).permute(0, 1, 3, 4, 2)              # (B, C, nh, dh, S)
    contrib = (xw.reshape(b, nch, nh * dh, t_c) @ bc32).reshape(b, nch, nh, dh, ds)
    decay = torch.exp(lseg[:, :, -1, :])                               # (B, C, nh)
    h_in = torch.empty_like(contrib)
    for c in range(nch):
        h_in[:, c] = state
        state = state * decay[:, c, :, None, None] + contrib[:, c]
    # carry-in: (c_t · h_in) exp(ℓ_t), (B, C, T, nh, dh)
    y_in = (h_in.reshape(b, nch, nh * dh, ds) @ cc32.transpose(-1, -2))
    y_in = y_in.reshape(b, nch, nh, dh, t_c).permute(0, 1, 4, 2, 3) * torch.exp(lseg)[..., None]
    ys = (y_in + y_intra).to(xh.dtype).reshape(b, s, nh, dh)
    return ys, state


def _ssd_chunk(h, xc, bc, cc, dtc, lc):
    """One chunk of the block form, the reference's checkpointed
    `chunk_body`: h (B, nh, dh, ds) f32 carried in, xc (B, T, nh, dh), bc /
    cc (B, T, ds) in the compute dtype, dtc and lc = cumsum(dt·a) (B, T, nh)
    f32.  Returns (h out, y (B, T, nh, dh) in xc's dtype)."""
    t_c = xc.shape[1]
    xc32, bc32, cc32 = xc.to(torch.float32), bc.to(torch.float32), cc.to(torch.float32)
    # carry-in: (c_t · h_in) exp(ℓ_t)
    y_in = (h @ cc32[:, None].transpose(-1, -2)).permute(0, 3, 1, 2) * torch.exp(lc)[..., None]
    # intra-chunk quasi-attention, heads ahead of (t, s)
    cb = cc32 @ bc32.transpose(-1, -2)                                 # (B, T, S)
    lh = lc.permute(0, 2, 1)                                           # (B, nh, T)
    causal = torch.ones((t_c, t_c), dtype=torch.bool, device=xc.device).tril()
    m = torch.exp(torch.where(causal, lh[..., :, None] - lh[..., None, :], -math.inf))
    m = m * cb[:, None]
    xdt = (xc32 * dtc[..., None]).permute(0, 2, 1, 3)                  # (B, nh, S, dh)
    y_intra = (m @ xdt).permute(0, 2, 1, 3)                            # (B, T, nh, dh)
    # carry-out: exp(ℓ_T) h_in + Σ_s exp(ℓ_T − ℓ_s)·dt_s·x_s b_sᵀ
    w_end = torch.exp(lc[:, -1:, :] - lc) * dtc                        # (B, S, nh)
    xw = (xc32 * w_end[..., None]).permute(0, 2, 3, 1)                 # (B, nh, dh, S)
    h_new = h * torch.exp(lc[:, -1, :])[:, :, None, None] + xw @ bc32[:, None]
    return h_new, (y_in + y_intra).to(xc.dtype)


def _ssd_blocks_remat(xh, bmat, cmat, dt, a, state):
    """The block form chunk by chunk, each chunk under checkpoint (the
    backward keeps one state per chunk).  Shapes and result as
    `_ssd_blocks`."""
    b, s, nh, _ = xh.shape
    t_c = SSD_CHUNK
    lseg = torch.cumsum((dt * a).reshape(b, s // t_c, t_c, nh), dim=2)
    ys = []
    for c in range(s // t_c):
        sl = slice(c * t_c, (c + 1) * t_c)
        state, y = blocks.remat(_ssd_chunk, state, xh[:, sl], bmat[:, sl], cmat[:, sl],
                                dt[:, sl], lseg[:, c])
        ys.append(y)
    return torch.cat(ys, dim=1), state


def mamba_block(lp: Params, x: torch.Tensor, cfg: ArchConfig, ssm_state: torch.Tensor,
                conv_state: Optional[torch.Tensor]):
    """x (B, S, d) -> (y (B, S, d), new ssm_state (B, nh, dh, ds) f32, new
    conv_state (B, K − 1, C)); the given states are not written."""
    spec = cfg.ssm
    b, s, d = x.shape
    di, nh, ds, dh = spec.d_inner(d), spec.n_heads(d), spec.d_state, spec.head_dim

    h = blocks.rms_norm(x, lp["ln"], cfg.norm_eps)
    z, xbc, dt = torch.split(h @ lp["in_proj"], [di, di + 2 * ds, nh], dim=-1)
    xbc, conv_state = _causal_conv(xbc, lp["conv_w"], lp["conv_b"], conv_state)
    xs, bmat, cmat = torch.split(xbc, [di, ds, ds], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + lp["dt_bias"].to(torch.float32))   # (B, S, nh)
    a = -torch.exp(lp["a_log"].to(torch.float32))                            # (nh,)
    xh = xs.reshape(b, s, nh, dh)
    if s % SSD_CHUNK == 0 and s > 1:
        by_chunk = torch.is_grad_enabled() and xh.requires_grad
        ys, ssm_state = (_ssd_blocks_remat if by_chunk else _ssd_blocks)(xh, bmat, cmat, dt, a,
                                                                         ssm_state)
        # the block form adds the skip term in the compute dtype
        y = ys + lp["d_skip"].to(torch.float32)[None, None, :, None].to(ys.dtype) * xh
    else:
        ys, ssm_state = _ssd_steps(xh, bmat, cmat, torch.exp(dt * a), dt, ssm_state)
        # the step form adds it in f32 and rounds once
        y = ys + lp["d_skip"].to(torch.float32)[None, None, :, None] * xh
    y = y.reshape(b, s, di).to(x.dtype)
    y = blocks.rms_norm(y, lp["norm_y"], cfg.norm_eps) * blocks.act_fn("silu")(z)
    return y @ lp["out_proj"], ssm_state, conv_state


# ---------------------------------------------------------------------------
# Zamba-2 hybrid model
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ArchConfig, *,
                device: torch.device = None) -> Params:
    """Random params drawn from `gen` (on the generator's device), placed on
    `device` (default: the generator's)."""
    cfg.validate()
    dtype = blocks.torch_dtype(cfg.param_dtype)
    d, dh = cfg.d_model, cfg.dh
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    v = cfg.padded_vocab
    device = gen.device if device is None else device

    def dense(d_in, d_out, scale=None):
        return blocks.dense_init(gen, d_in, d_out, dtype, scale).to(device)

    shared = {
        "ln1": torch.ones((2 * d,), dtype=dtype, device=device),
        "ln2": torch.ones((2 * d,), dtype=dtype, device=device),
        "wq": dense(2 * d, hq * dh), "wk": dense(2 * d, hkv * dh),
        "wv": dense(2 * d, hkv * dh), "wo": dense(hq * dh, d),
        "w_in": dense(2 * d, cfg.d_ff), "w_gate": dense(2 * d, cfg.d_ff),
        "w_out": dense(cfg.d_ff, d),
    }
    return {
        "embed": dense(v, d, scale=1.0),
        "layers": blocks.stacked(lambda i: mamba_init(gen, cfg, dtype, device), cfg.n_layers),
        "shared": shared,
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": dense(d, v),
    }


def n_shared_slots(cfg: ArchConfig) -> int:
    return -(-cfg.n_layers // cfg.hybrid.attn_every)


def _shared_qkv(sp: Params, x, x0, cfg: ArchConfig, positions):
    """The shared block's roped q, k and v from concat(x, x_embed)."""
    b, s, _ = x.shape
    h = blocks.rms_norm(torch.cat([x, x0], dim=-1), sp["ln1"], cfg.norm_eps)
    q = (h @ sp["wq"]).reshape(b, s, cfg.n_heads, cfg.dh)
    k = (h @ sp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.dh)
    vv = (h @ sp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.dh)
    return (blocks.apply_rope(q, positions, cfg.rope_theta),
            blocks.apply_rope(k, positions, cfg.rope_theta), vv)


def _shared_attn_train(sp: Params, x, x0, cfg: ArchConfig, positions, backend: str):
    """The shared block on the full sequence -> (x, (k, v))."""
    b, s, _ = x.shape
    q, k, vv = _shared_qkv(sp, x, x0, cfg, positions)
    attn = blocks.flash_attention(q, k, vv, causal=True, window=cfg.sliding_window,
                                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk, backend=backend)
    x = x + attn.reshape(b, s, -1) @ sp["wo"]
    return x + _shared_mlp(sp, x, x0, cfg), (k, vv)


def _shared_mlp(sp: Params, x, x0, cfg: ArchConfig):
    h2 = blocks.rms_norm(torch.cat([x, x0], dim=-1), sp["ln2"], cfg.norm_eps)
    return (blocks.act_fn(cfg.act)(h2 @ sp["w_gate"]) * (h2 @ sp["w_in"])) @ sp["w_out"]


def _zero_ssm_state(cfg: ArchConfig, b: int, device) -> torch.Tensor:
    spec = cfg.ssm
    return torch.zeros((b, spec.n_heads(cfg.d_model), spec.head_dim, spec.d_state),
                       dtype=torch.float32, device=device)


def hidden_states(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
                  remat: bool = True, execution: Execution = Execution()
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence backbone from zero states -> (final normed hidden, {}),
    the reference's training forward: every f32 layer leaf cast to the
    compute dtype (`blocks.cast_stacked`), the shared block cast once
    outside the layers; with `remat` each layer, with the shared block where
    it applies, under checkpoint."""
    execution.torch_device()
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    x = blocks.embed(params, batch["tokens"], cdt)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    shared = blocks.cast(params["shared"], cdt)

    def body(x, x0, lp, use_attn):
        y, _, _ = mamba_block(blocks.cast_stacked(blocks.gather_layer(lp), cdt), x, cfg,
                              _zero_ssm_state(cfg, b, x.device), None)
        x = x + y
        if use_attn:
            x, _ = _shared_attn_train(shared, x, x0, cfg, positions, execution.backend)
        return x

    x0 = x
    for i, lp in enumerate(blocks.unstacked(params)):
        args = (x, x0, lp, i % cfg.hybrid.attn_every == 0)
        x = blocks.remat(body, *args) if remat else body(*args)
    return blocks.rms_norm(x, params["final_norm"], cfg.norm_eps), {}


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            remat: bool = True, execution: Execution = Execution()):
    """(mean next-token NLL, {"ce": it}) from zero states."""
    x, _ = hidden_states(params, batch, cfg, remat=remat, execution=execution)
    targets = batch["tokens"][:, 1:]
    loss = blocks.chunked_softmax_xent(x[:, :-1], params["lm_head"], targets)
    return loss, {"ce": loss}


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            remat: bool = True, execution: Execution = Execution()
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(full logits (B, S, V) in f32, aux)."""
    x, aux = hidden_states(params, batch, cfg, remat=remat, execution=execution)
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    return (x @ params["lm_head"].to(cdt)).to(torch.float32), aux


# ---------------------------------------------------------------------------
# serving: states + the shared block's KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, cache_size: int,
               device: torch.device, *, seq_shards: int = 1) -> Dict[str, torch.Tensor]:
    """Zero cache: {"ssm": (L, B, nh, dh, ds) f32, "conv": (L, B, K − 1,
    d_inner + 2·ds), "k", "v": (slots, B, keep, Hkv, Dh) in the compute
    dtype, "len", "pos": int32 scalars on the host}; one k / v slot per
    application of the shared block, `keep` bounded by the window under
    SWA; with `seq_shards` = n, one rank's block of keep / n slots."""
    d = cfg.d_model
    spec = cfg.ssm
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    keep = cache_slots(cfg, cache_size) // seq_shards
    kv = (n_shared_slots(cfg), batch, keep, cfg.n_kv_heads, cfg.dh)
    conv_ch = spec.d_inner(d) + 2 * spec.d_state
    return {
        "ssm": torch.zeros((cfg.n_layers, batch, spec.n_heads(d), spec.head_dim, spec.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, spec.d_conv - 1, conv_ch), dtype=cdt,
                            device=device),
        "k": torch.zeros(kv, dtype=cdt, device=device),
        "v": torch.zeros(kv, dtype=cdt, device=device),
        "len": torch.tensor(0, dtype=torch.int32),
        "pos": torch.tensor(0, dtype=torch.int32),
    }


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            cache_size: int, *, execution: Execution = Execution()):
    """Runs the prompt, returns (last-position logits (B, V) f32, cache as
    `init_cache` lays it out): each layer's SSD state and conv inputs, and
    at each shared-block slot the last `keep` keys / values of the prompt
    at slots 0..keep-1."""
    dev = execution.torch_device()
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    x = blocks.embed(params, batch["tokens"], cdt)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    shared = blocks.cast(params["shared"], cdt)
    every = cfg.hybrid.attn_every
    _, r, n_kv = shard_rules.kv_seq_shard()
    cache = init_cache(cfg, b, cache_size, dev, seq_shards=n_kv)
    n = min(s, cache["k"].shape[2] * n_kv)
    lo, cnt = prompt_slots(n, cache["k"].shape[2], r)
    x0 = x
    for i in range(cfg.n_layers):
        lp = blocks.cast(blocks.gather_layer(blocks.layer_params(params, i)), cdt)
        y, ssm_st, conv_st = mamba_block(lp, x, cfg, _zero_ssm_state(cfg, b, x.device), None)
        x = x + y
        cache["ssm"][i] = ssm_st
        cache["conv"][i] = conv_st
        if i % every == 0:
            x, (k, vv) = _shared_attn_train(shared, x, x0, cfg, positions, execution.backend)
            if cnt:
                cache["k"][i // every, :, :cnt] = k[:, s - n + lo:s - n + lo + cnt]
                cache["v"][i // every, :, :cnt] = vv[:, s - n + lo:s - n + lo + cnt]
    x = blocks.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"].to(cdt)).to(torch.float32)
    cache["len"] = torch.tensor(n, dtype=torch.int32)
    cache["pos"] = torch.tensor(s, dtype=torch.int32)
    return logits[:, 0], cache


def decode_step(params: Params, token: torch.Tensor, cache: Dict[str, torch.Tensor],
                cfg: ArchConfig, *, execution: Execution = Execution()):
    """One token: token (B,) int -> (logits (B, V) f32, updated cache).

    Each layer's `ssm` / `conv` state and the shared block's new key and
    value are written into the given cache's tensors in place (the
    reference donates the cache to the same effect); the returned dict
    holds those tensors and the advanced `len` / `pos`.  The KV slot is
    `len` while the cache fills, then `pos % S` (the reference's ring)."""
    execution.torch_device()
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    x = blocks.embed(params, token[:, None], cdt)                             # (B, 1, d)
    b = x.shape[0]
    shared = blocks.cast(params["shared"], cdt)
    every = cfg.hybrid.attn_every
    shard = shard_rules.kv_seq_shard()
    s_loc = cache["k"].shape[2]
    s_max = s_loc * shard[2]
    pos, n = int(cache["pos"]), int(cache["len"])
    slot = n if n < s_max else pos % s_max
    owner, j = divmod(slot, s_loc)
    new_len = min(n + 1, s_max)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    x0 = x
    for i in range(cfg.n_layers):
        lp = blocks.cast(blocks.gather_layer(blocks.layer_params(params, i)), cdt)
        y, ssm_st, conv_st = mamba_block(lp, x, cfg, cache["ssm"][i], cache["conv"][i])
        cache["ssm"][i] = ssm_st
        cache["conv"][i] = conv_st
        x = x + y
        if i % every == 0:
            q, k, vv = _shared_qkv(shared, x, x0, cfg, positions)
            k_c, v_c = cache["k"][i // every], cache["v"][i // every]
            if owner == shard[1]:
                k_c[:, j] = k[:, 0].to(k_c.dtype)
                v_c[:, j] = vv[:, 0].to(v_c.dtype)
            attn = blocks.decode_attention(q, k_c, v_c, new_len, window=cfg.sliding_window,
                                           seq_shard=shard)
            x = x + attn.reshape(b, 1, -1) @ shared["wo"]
            x = x + _shared_mlp(shared, x, x0, cfg)
    x = blocks.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ params["lm_head"].to(cdt)).to(torch.float32)
    new_cache = {"ssm": cache["ssm"], "conv": cache["conv"], "k": cache["k"], "v": cache["v"],
                 "len": torch.tensor(new_len, dtype=torch.int32),
                 "pos": torch.tensor(pos + 1, dtype=torch.int32)}
    return logits, new_cache
