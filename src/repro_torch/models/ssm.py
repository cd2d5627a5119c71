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
no second whole-model copy exists).  The shared block's prefill attention
goes through the flash kernel when the `Execution` says `backend="kernel"`;
its decode attention and both SSD forms are plain PyTorch, as the
reference's are jnp outside any Pallas kernel.

On a mesh the layers compute on the rank's shards (`dist.sharding.
LayerShard`).  With one `model` rank, or where the ranks do not divide
d_model, each layer gathers its leaves whole (`blocks.gather_layer`).
Otherwise the layers split over `model` as the reference pins them
(`_tp`): a Mamba-2 layer by SSD head — z, xs and dt from the rank's
`in_proj` columns, B and C whole on every rank, the conv on its channels,
`norm_y` across the ranks, `out_proj` row-parallel — and the shared block
by head (B4 on the rank's heads) and by d_ff, its input concat(x, x0)
gathered whole.  In training the carry x and the embedding x0 are split by
feature between layers, (B_local, S, d / n), which is what `remat` keeps
(the reference's `constrain(x, "batch", None, "model")`: its scan needs the
whole sequence); each layer gathers x along d and its row-parallel outputs
reduce-scatter back, and each rank of `model` holds its share of the loss.
Prefill keeps the stream whole (the outputs all-reduced) and gathers each
layer's SSD state and conv inputs into the replicated cache; decode runs
every product on the stored columns and every head against that cache.
Heads the ranks do not divide run whole on every rank (the degrade rule).
The shared block's K/V cache keeps its slots split over "model" as the
transformer's does.

`mamba_block` keeps both of the reference's forms and their rounding
points: the block form (Mamba-2's chunked algorithm) when the sequence is a
multiple of `SSD_CHUNK` longer than 1, the step recurrence otherwise
(decode, and prompts that are not a multiple).  The block form adds the
skip term in the compute dtype, the step form in f32 with one rounding.
When grad is needed the block form runs chunk by chunk, each chunk under
checkpoint as in the reference (`_ssd_chunk`); without grad it batches
every chunk's intra-chunk and carry-out terms (`_ssd_blocks`), the same
arithmetic in another order.  The backward is autograd through either
form.  Each layer's scan runs under the span `ssm.ssd` (`repro_torch.obs`).

Zamba2's published layout (a config whose `hybrid` is the port's own
`SharedBlocksSpec`, `ssm` its `GroupedSSMSpec`; the section at the end)
serves on one rank through the same `prefill`, `decode_step`,
`init_cache` and `init_params`: two shared blocks in alternation at the
listed layers, each use with its adapter and output Linear under the span
`zamba.shared`, B and C in groups, the gate before a per-group norm.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core.execution import Execution
from repro_torch.dist import sharding as shard_rules
from repro_torch.models import blocks, transformer
from repro_torch.models.transformer import cache_slots, prompt_slots
from repro_torch.models.config import ArchConfig, GroupedSSMSpec, SharedBlocksSpec

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
    `_ssd_steps`, a f32 broadcast against dt ((nh,) or (B, 1, nh)).  Returns (ys in xh's dtype, final state)."""
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


class _Reads(NamedTuple):
    """A Mamba-2 layer's leaves as one rank computes with them: tensors,
    and the products and norms as functions of their input."""
    ln: torch.Tensor
    proj_in: Callable        # h -> [z | xbc | dt]
    conv: Callable           # (xbc, conv state) -> (silu(conv(xbc) + b), new state)
    a_log: torch.Tensor
    d_skip: torch.Tensor
    dt_bias: torch.Tensor
    norm_y: Callable         # y -> rms_norm(y, norm_y)
    proj_out: Callable       # y -> y @ out_proj


def _whole_reads(lp: Params, cfg: ArchConfig) -> _Reads:
    lp = blocks.gather_layer(lp)
    return _Reads(lp["ln"], lambda h: h @ lp["in_proj"],
                  lambda xbc, st: _causal_conv(xbc, lp["conv_w"], lp["conv_b"], st),
                  lp["a_log"], lp["d_skip"], lp["dt_bias"],
                  lambda y: blocks.rms_norm(y, lp["norm_y"], cfg.norm_eps),
                  lambda y: y @ lp["out_proj"])


def _ssd_cols(cfg: ArchConfig, n: int):
    """Per rank of "model", as column ranges: (its `in_proj` columns — z,
    xs and dt of its SSD heads, and B / C, which every rank reads — and its
    conv channels, xs of its heads and B / C); n divides the heads."""
    spec = cfg.ssm
    di, nh, ds, dh = (spec.d_inner(cfg.d_model), spec.n_heads(cfg.d_model), spec.d_state,
                      spec.head_dim)
    k = nh // n
    inp = [((j * k * dh, (j + 1) * k * dh), (di + j * k * dh, di + (j + 1) * k * dh),
            (2 * di, 2 * di + 2 * ds), (2 * di + 2 * ds + j * k, 2 * di + 2 * ds + (j + 1) * k))
           for j in range(n)]
    conv = [((j * k * dh, (j + 1) * k * dh), (di, di + 2 * ds)) for j in range(n)]
    return inp, conv


def _head_reads(lp: Params, cfg: ArchConfig, tp) -> _Reads:
    """This rank's SSD heads (train, prefill): `in_proj` and the conv by
    `_ssd_cols`, the per-head and per-channel vectors by their stored
    block, `norm_y` across the ranks, `out_proj` row-parallel (its output
    a partial sum)."""
    inp, conv = _ssd_cols(cfg, tp.n)
    w_in, w_conv, b_conv = lp["in_proj"].cols(inp), lp["conv_w"].cols(conv), lp["conv_b"].cols(conv)
    norm_y, w_out = lp["norm_y"].block(), lp["out_proj"].rows()
    return _Reads(lp["ln"].whole(), lambda h: h @ w_in,
                  lambda xbc, st: _causal_conv(xbc, w_conv, b_conv, st),
                  lp["a_log"].block(), lp["d_skip"].block(), lp["dt_bias"].block(),
                  lambda y: blocks.rms_norm_split(y, norm_y, cfg.norm_eps, tp.mesh),
                  lambda y: y @ w_out)


def _conv_stored(w, bias, xbc: torch.Tensor, state: torch.Tensor, tp):
    """Decode's conv on every channel: this rank's stored channels, the
    (B, 1, ·) outputs gathered over "model"; the new state (the last K − 1
    inputs) from the whole input every rank holds."""
    if not w.model_split:
        return _causal_conv(xbc, w.whole(), bias.whole(), state)
    wb = w.block()
    c = wb.shape[-1]
    own = slice(tp.r * c, (tp.r + 1) * c)
    y, _ = _causal_conv(xbc[..., own], wb, bias.block(), state[..., own])
    xin = torch.cat([state.to(xbc.dtype), xbc], dim=1)
    return shard_rules.all_gather_cat(y, tp.mesh, "model", 2), xin[:, -(wb.shape[0] - 1):]


def _stored_reads(lp: Params, cfg: ArchConfig, tp) -> _Reads:
    """Decode, every head on each rank against the replicated states: each
    product on the rank's stored columns, the (B, 1, ·) outputs gathered
    over "model" (`transformer._all_cols`); the conv likewise; the vectors
    whole."""
    return _Reads(lp["ln"].whole(), lambda h: transformer._all_cols(lp["in_proj"], h, tp),
                  lambda xbc, st: _conv_stored(lp["conv_w"], lp["conv_b"], xbc, st, tp),
                  lp["a_log"].whole(), lp["d_skip"].whole(), lp["dt_bias"].whole(),
                  lambda y: blocks.rms_norm(y, lp["norm_y"].whole(), cfg.norm_eps),
                  lambda y: transformer._all_cols(lp["out_proj"], y, tp))


def mamba_block(lp: Params, x: torch.Tensor, cfg: ArchConfig, ssm_state: torch.Tensor,
                conv_state: Optional[torch.Tensor], tp=None, every_head: bool = False):
    """x (B, S, d) -> (y (B, S, d), new ssm_state (B, nh, dh, ds) f32, new
    conv_state (B, K − 1, C)); the given states are not written.

    Without `tp`, or with one that does not split, every leaf whole
    (`_whole_reads`, a layer of `LayerShard`s gathered).  With a split
    (`_tp`): this rank's SSD heads nh / n on the whole x (`_head_reads`),
    y then this rank's partial sum of the row-parallel `out_proj` and the
    states those of its heads and channels; with `every_head` (decode)
    every head on the stored columns (`_stored_reads`)."""
    spec = cfg.ssm
    b, s, d = x.shape
    if tp is None or tp.n == 1:
        rd, n = _whole_reads(lp, cfg), 1
    elif every_head:
        rd, n = _stored_reads(lp, cfg, tp), 1
    else:
        rd, n = _head_reads(lp, cfg, tp), tp.n
    di, nh, ds, dh = spec.d_inner(d) // n, spec.n_heads(d) // n, spec.d_state, spec.head_dim
    g = spec.n_groups if isinstance(spec, GroupedSSMSpec) else 1

    h = blocks.rms_norm(x, rd.ln, cfg.norm_eps)
    z, xbc, dt = torch.split(rd.proj_in(h), [di, di + 2 * g * ds, nh], dim=-1)
    xbc, conv_state = rd.conv(xbc, conv_state)
    xs, bmat, cmat = torch.split(xbc, [di, g * ds, g * ds], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + rd.dt_bias.to(torch.float32))     # (B, S, nh)
    a = -torch.exp(rd.a_log.to(torch.float32))                              # (nh,)
    xh = xs.reshape(b, s, nh, dh)
    block = s % SSD_CHUNK == 0 and s > 1
    with obs.span("ssm.ssd"):
        ys, ssm_state = _ssd(xh, bmat, cmat, dt, a, ssm_state, g, block)
    if block:
        # the block form adds the skip term in the compute dtype
        y = ys + rd.d_skip.to(torch.float32)[None, None, :, None].to(ys.dtype) * xh
    else:
        # the step form adds it in f32 and rounds once
        y = ys + rd.d_skip.to(torch.float32)[None, None, :, None] * xh
    y = y.reshape(b, s, di).to(x.dtype)
    if isinstance(spec, GroupedSSMSpec):
        y = _gated_group_norm(y, z, blocks.gather_layer(lp)["norm_y"], g, cfg.norm_eps)
    else:
        y = rd.norm_y(y) * blocks.act_fn("silu")(z)
    return rd.proj_out(y), ssm_state, conv_state


def _ssd(xh, bmat, cmat, dt, a, state, g: int, block: bool):
    """The SSD of every head, block form (`block`) or step form; head h
    reads B and C of group h // (nh / g), bmat / cmat (B, S, g·ds).  The
    groups go into the batch, (B, S, g·k, ·) -> (B·g, S, k, ·), so one scan
    serves them all.  Shapes otherwise as `_ssd_steps`, a (nh,) f32."""
    b, s, nh, dh = xh.shape
    k, ds = nh // g, bmat.shape[-1] // g
    xg = xh.reshape(b, s, g, k, dh).transpose(1, 2).reshape(b * g, s, k, dh)
    bg, cg = (m.reshape(b, s, g, ds).transpose(1, 2).reshape(b * g, s, ds) for m in (bmat, cmat))
    dtg = dt.reshape(b, s, g, k).transpose(1, 2).reshape(b * g, s, k)
    ag = a.reshape(g, k).repeat(b, 1)[:, None]                              # (B·g, 1, k)
    state = state.reshape(b * g, k, dh, ds)
    if block:
        by_chunk = torch.is_grad_enabled() and xh.requires_grad
        ys, state = (_ssd_blocks_remat if by_chunk else _ssd_blocks)(xg, bg, cg, dtg, ag, state)
    else:
        ys, state = _ssd_steps(xg, bg, cg, torch.exp(dtg * ag), dtg, state)
    return ys.reshape(b, g, s, k, dh).transpose(1, 2).reshape(b, s, nh, dh), \
        state.reshape(b, nh, dh, ds)


def _gated_group_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, g: int,
                      eps: float) -> torch.Tensor:
    """HF's `Zamba2RMSNormGated` in f32: y · silu(z), then an RMS norm over
    each of g groups of channels, rounded to y's dtype, times w."""
    y32 = y.to(torch.float32) * F.silu(z.to(torch.float32))
    grp = y32.reshape(*y32.shape[:-1], g, -1)
    y32 = (grp * torch.rsqrt(torch.mean(torch.square(grp), dim=-1, keepdim=True) + eps)
           ).reshape(y32.shape)
    return (y32.to(y.dtype).to(torch.float32) * w.to(torch.float32)).to(y.dtype)


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
    if published(cfg):
        return _published_init(gen, cfg, dtype, device)

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
    if published(cfg):
        return len(cfg.hybrid.layer_ids)
    return -(-cfg.n_layers // cfg.hybrid.attn_every)


# ---------------------------------------------------------------------------
# the split over "model"
# ---------------------------------------------------------------------------

class _TP(NamedTuple):
    """How a Zamba-2 step splits over "model" (`_tp`); `_WHOLE` where it
    does not."""
    mesh: Any
    r: int          # this rank's index along "model"
    n: int          # "model" ranks
    feat: bool      # training: the carry split by feature, each rank its share of the loss
    ssd: bool       # the SSD heads split: rank r computes heads r·nh/n ..
    heads: bool     # the shared block's query heads split
    ffn: bool       # the shared MLP's d_ff splits


_WHOLE = _TP(None, 0, 1, False, False, False, False)


def splits(cfg: ArchConfig, n: int) -> bool:
    """Whether Zamba-2's layers split over n ranks of "model": more than
    one, dividing d_model (the reference pins the training carry's d over
    `model`; where n does not divide it, its `constrain` pins nothing)."""
    return n > 1 and cfg.d_model % n == 0


def _tp(params: Params, cfg: ArchConfig) -> _TP:
    """The split of a step's layers over "model", read from their shards:
    `_WHOLE` without a mesh, with one `model` rank, or where the ranks do
    not divide d_model (every step then computes as on one rank)."""
    split = shard_rules.model_split_of(params["layers"]["in_proj"])
    if split is None or not splits(cfg, split[2]):
        return _WHOLE
    mesh, r, n, seq = split
    return _TP(mesh, r, n, seq, cfg.ssm.n_heads(cfg.d_model) % n == 0,
               transformer.splits_heads(cfg, n), cfg.d_ff % n == 0)


def _stream(x: torch.Tensor, tp: _TP) -> torch.Tensor:
    """The whole stream: the carry gathered along d where it splits by
    feature (`GatherRows`: each rank's gradient of it is a part, summed
    and scattered back), else x itself."""
    return shard_rules.GatherRows.apply(x, tp.mesh, "model", 2) if tp.feat else x


def _own(y: torch.Tensor, tp: _TP) -> torch.Tensor:
    """A whole (B, S, d) output in the carry's layout: this rank's feature
    block where the carry splits (every rank computed y whole, so its
    gradient is the block's, zeros elsewhere), else y."""
    if not tp.feat:
        return y
    dn = y.shape[-1] // tp.n
    return y[..., tp.r * dn:(tp.r + 1) * dn]


def _leave(o: torch.Tensor, tp: _TP) -> torch.Tensor:
    """A row-parallel product's partial sums in the carry's layout:
    reduce-scattered along d (`ScatterSeq`), or all-reduced on a whole
    stream (`ReduceModel`)."""
    if tp.feat:
        return shard_rules.ScatterSeq.apply(o, tp.mesh, 2)
    return shard_rules.ReduceModel.apply(o, tp.mesh)


# ---------------------------------------------------------------------------
# the shared attention + MLP block
# ---------------------------------------------------------------------------

def _times(w: torch.Tensor) -> Callable:
    return lambda h: h @ w


def _shared_params(sp: Params, cfg: ArchConfig, cdt: torch.dtype, tp: _TP) -> Params:
    """The shared block's leaves as train and prefill compute with them,
    cast to the compute dtype once a step (the reference casts them once
    outside its layer scan): the norms whole, each matrix a function
    h -> h @ it.  Where the heads split, this rank's query heads' and K/V
    heads' columns of `wq` / `wk` / `wv` and `wo`'s rows; where d_ff
    splits, its d_ff columns of `w_in` / `w_gate` and `w_out`'s rows; the
    rest whole."""
    sp = blocks.cast(sp, cdt)
    part = {}
    if tp.heads:
        dh, ranges = cfg.dh, transformer._head_ranges(cfg, tp.n)
        kv = [(a * dh, c * dh) for _, (a, c) in ranges]
        part.update(wq=sp["wq"].cols([(a * dh, c * dh) for (a, c), _ in ranges]),
                    wk=sp["wk"].cols(kv), wv=sp["wv"].cols(kv), wo=sp["wo"].rows())
    if tp.ffn:
        f = cfg.d_ff // tp.n
        part.update({k: sp[k].cols([(j * f, (j + 1) * f) for j in range(tp.n)])
                     for k in ("w_in", "w_gate")}, w_out=sp["w_out"].rows())
    out = {k: part[k] if k in part else shard_rules.read_whole(v) for k, v in sp.items()}
    return {k: (w if k in ("ln1", "ln2") else _times(w)) for k, w in out.items()}


def _decode_shared(sp: Params, tp: _TP) -> Params:
    """Decode's shared block, read once a step: the norms whole, each
    matrix a function h -> h @ it, on the rank's stored columns (gathered
    over the DP axes once) with the (B, 1, ·) product gathered over
    "model" where "model" splits it (`transformer._all_cols`' arithmetic),
    else whole."""
    def mat(w):
        if tp.mesh is None or not w.model_split:
            return _times(shard_rules.read_whole(w))
        blk = w.block()
        return lambda h: shard_rules.all_gather_cat(h @ blk, tp.mesh, "model", h.ndim - 1)

    return {k: (shard_rules.read_whole(w) if k in ("ln1", "ln2") else mat(w))
            for k, w in sp.items()}


def _qkv(sp: Params, h: torch.Tensor, cfg: ArchConfig, positions, heads=None):
    """Roped q, k and v of the normed concat h; `heads` = (query heads,
    K/V heads) where `sp` holds only a rank's columns of them."""
    b, s, _ = h.shape
    hq, hkv = heads or (cfg.n_heads, cfg.n_kv_heads)
    q = sp["wq"](h).reshape(b, s, hq, cfg.dh)
    k = sp["wk"](h).reshape(b, s, hkv, cfg.dh)
    vv = sp["wv"](h).reshape(b, s, hkv, cfg.dh)
    return (blocks.apply_rope(q, positions, cfg.rope_theta),
            blocks.apply_rope(k, positions, cfg.rope_theta), vv)


def _mlp(sp: Params, h2: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The shared MLP of the normed concat h2."""
    return sp["w_out"](blocks.act_fn(cfg.act)(sp["w_gate"](h2)) * sp["w_in"](h2))


def _shared_block(sp: Params, x, x0, cfg: ArchConfig, positions, backend: str, tp: _TP):
    """The shared block on the full sequence (`sp` from `_shared_params`)
    -> (x, (k, v, first K/V head held)); x and x0 are the carry's layout.
    Its input concat(x, x0) is gathered whole; where the heads split, B4
    runs on this rank's query heads and the K/V heads they read and `wo`'s
    partial sums leave through `_leave`, else every head on every rank;
    the MLP likewise by d_ff."""
    b, s, _ = x.shape
    x0f = _stream(x0, tp)
    h = blocks.rms_norm(torch.cat([_stream(x, tp), x0f], dim=-1), sp["ln1"], cfg.norm_eps)
    if tp.heads:
        qh, kh = transformer._head_ranges(cfg, tp.n)[tp.r]
        q, k, vv = _qkv(sp, h, cfg, positions, (qh[1] - qh[0], kh[1] - kh[0]))
    else:
        (q, k, vv), kh = _qkv(sp, h, cfg, positions), (0, cfg.n_kv_heads)
    attn = blocks.flash_attention(q, k, vv, causal=True, window=cfg.sliding_window,
                                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk, backend=backend)
    o = sp["wo"](attn.reshape(b, s, -1))
    x = x + (_leave(o, tp) if tp.heads else _own(o, tp))
    h2 = blocks.rms_norm(torch.cat([_stream(x, tp), x0f], dim=-1), sp["ln2"], cfg.norm_eps)
    y = _mlp(sp, h2, cfg)
    return x + (_leave(y, tp) if tp.ffn else _own(y, tp)), (k, vv, kh[0])


def _zero_ssm_state(cfg: ArchConfig, b: int, device, n: int = 1) -> torch.Tensor:
    """Zero SSD states of nh / n heads."""
    spec = cfg.ssm
    return torch.zeros((b, spec.n_heads(cfg.d_model) // n, spec.head_dim, spec.d_state),
                       dtype=torch.float32, device=device)


def _mamba_layer(lp: Params, x: torch.Tensor, cfg: ArchConfig, tp: _TP):
    """A Mamba-2 layer on the whole stream x from zero states -> (its
    output in the carry's layout, the SSD state and conv inputs of this
    rank's heads and channels, or of every one): this rank's SSD heads
    where they split, else the whole layer on every rank."""
    if tp.ssd:
        y, ssm_st, conv_st = mamba_block(lp, x, cfg, _zero_ssm_state(cfg, x.shape[0], x.device,
                                                                     tp.n), None, tp)
        return _leave(y, tp), ssm_st, conv_st
    y, ssm_st, conv_st = mamba_block(lp, x, cfg, _zero_ssm_state(cfg, x.shape[0], x.device),
                                     None)
    return _own(y, tp), ssm_st, conv_st


def hidden_states(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
                  remat: bool = True, execution: Execution = Execution()
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence backbone from zero states -> (final normed hidden,
    aux), the reference's training forward: every f32 layer leaf cast to
    the compute dtype (`blocks.cast_stacked`), the shared block cast once
    outside the layers; with `remat` each layer, with the shared block where
    it applies, under checkpoint.  aux holds `split`: None, or where the
    train step splits the layers over "model" (`_tp` with `feat`), the
    split and the first position of this rank's block of the final hidden
    states, which is then what they hold (B, its positions, d).

    On that split the carry x and the embedding x0 are this rank's
    feature block (B_local, S, d / n) between layers (what `remat` keeps);
    each layer gathers x along d for its norm and its products, and the
    row-parallel outputs reduce-scatter back into the block.  Each rank of
    `model` holds its share of the loss: after the last layer the stream is
    gathered and each rank runs the final norm and the head on its
    positions (`loss_fn`)."""
    execution.torch_device()
    if published(cfg):
        raise NotImplementedError(f"{cfg.name}: the published Zamba2 layout serves only; its "
                                  f"training waits on the attention backward at Dh {cfg.dh}")
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    tp = _tp(params, cfg)
    tp = tp if tp.feat else _WHOLE
    x = blocks.embed(params, batch["tokens"], cdt)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    shared = _shared_params(params["shared"], cfg, cdt, tp)

    def body(x, x0, lp, use_attn):
        x = x + _mamba_layer(blocks.cast_stacked(lp, cdt), _stream(x, tp), cfg, tp)[0]
        if use_attn:
            x, _ = _shared_block(shared, x, x0, cfg, positions, execution.backend, tp)
        return x

    x = _own(x, tp)
    x0 = x
    for i, lp in enumerate(blocks.unstacked(params)):
        args = (x, x0, lp, i % cfg.hybrid.attn_every == 0)
        x = blocks.remat(body, *args) if remat else body(*args)
    split = None
    if tp.feat:
        lo, hi = tp.r * s // tp.n, (tp.r + 1) * s // tp.n
        x, split = _stream(x, tp)[:, lo:hi], (tp, lo)
    return blocks.rms_norm(x, params["final_norm"], cfg.norm_eps), {"split": split}


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            remat: bool = True, execution: Execution = Execution()):
    """(mean next-token NLL, {"ce": it}) from zero states.  Where the
    layers split over "model" each rank runs the head and the NLL on its
    block of positions, and the loss is this rank's share: its NLL sum over
    the count of every rank's targets (the shares sum to the loss; `ce` is
    the whole)."""
    x, aux = hidden_states(params, batch, cfg, remat=remat, execution=execution)
    tokens = batch["tokens"].to(x.device)
    if aux["split"] is not None:
        tp, lo = aux["split"]
        targets = transformer._stream_targets(tokens, 0, tokens.shape[1], True)
        nll, count = blocks.chunked_xent_sums(x, params["lm_head"],
                                              targets[:, lo:lo + x.shape[1]])
        count = shard_rules.all_reduce_sum_(count.detach().clone(), tp.mesh, "model")
        loss = nll / torch.clamp(count, min=1.0)
        return loss, {"ce": shard_rules.all_reduce_sum_(loss.detach().clone(), tp.mesh, "model")}
    loss = blocks.chunked_softmax_xent(x[:, :-1], params["lm_head"], tokens[:, 1:])
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
    groups = spec.n_groups if isinstance(spec, GroupedSSMSpec) else 1
    conv_ch = spec.d_inner(d) + 2 * groups * spec.d_state
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


def _whole_states(ssm_st: torch.Tensor, conv_st: torch.Tensor, cfg: ArchConfig, tp: _TP):
    """A prefill layer's final SSD state and conv inputs of this rank's
    heads and channels, gathered over "model" into the cache's layout
    (every head, every channel, as `cache_specs` replicates them)."""
    di = cfg.ssm.d_inner(cfg.d_model) // tp.n
    xs = shard_rules.all_gather_cat(conv_st[..., :di], tp.mesh, "model", 2)
    return (shard_rules.all_gather_cat(ssm_st, tp.mesh, "model", 1),
            torch.cat([xs, conv_st[..., di:]], dim=-1))


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            cache_size: int, *, execution: Execution = Execution()):
    """Runs the prompt, returns (last-position logits (B, V) f32, cache as
    `init_cache` lays it out): each layer's SSD state and conv inputs, and
    at each shared-block slot the last `keep` keys / values of the prompt
    at slots 0..keep-1.  Where the layers split over "model" (`_tp`) the
    stream stays whole and the products split as in training: each rank's
    SSD heads (their final states and conv inputs gathered over "model"
    into the cache), the shared block's heads and d_ff, the row-parallel
    outputs all-reduced; where a rank holds only some K/V heads, each rank
    gets every head of its cache slots from the ranks that hold them
    (`transformer._kv_slots`)."""
    dev = execution.torch_device()
    if published(cfg):
        return _published_prefill(params, batch, cfg, cache_size, dev, execution.backend)
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    tp = _tp(params, cfg)
    x = transformer._embed_rows(params, batch["tokens"], cdt)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    shared = _shared_params(params["shared"], cfg, cdt, tp)
    every = cfg.hybrid.attn_every
    _, r, n_kv = shard_rules.kv_seq_shard()
    cache = init_cache(cfg, b, cache_size, dev, seq_shards=n_kv)
    slots = cache["k"].shape[2]
    n = min(s, slots * n_kv)
    lo, cnt = prompt_slots(n, slots, r)
    # whether some rank holds only some K/V heads (the same answer on every rank)
    some_heads = tp.heads and any(
        c - a < cfg.n_kv_heads for _, (a, c) in transformer._head_ranges(cfg, tp.n))
    x0 = x
    for i in range(cfg.n_layers):
        lp = blocks.cast(blocks.layer_params(params, i), cdt)
        y, ssm_st, conv_st = _mamba_layer(lp, x, cfg, tp)
        if tp.ssd:
            ssm_st, conv_st = _whole_states(ssm_st, conv_st, cfg, tp)
        x = x + y
        cache["ssm"][i] = ssm_st
        cache["conv"][i] = conv_st
        if i % every == 0:
            x, (k, vv, k0) = _shared_block(shared, x, x0, cfg, positions, execution.backend, tp)
            j = i // every
            if some_heads:
                cache["k"][j, :, :cnt] = transformer._kv_slots(k, k0, tp, cfg, s, n, slots, n_kv,
                                                               None)
                cache["v"][j, :, :cnt] = transformer._kv_slots(vv, k0, tp, cfg, s, n, slots,
                                                               n_kv, None)
            elif cnt:
                cache["k"][j, :, :cnt] = k[:, s - n + lo:s - n + lo + cnt]
                cache["v"][j, :, :cnt] = vv[:, s - n + lo:s - n + lo + cnt]
    x = blocks.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = transformer._logits(params, x, cfg, cdt)
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
    `len` while the cache fills, then `pos % S` (the reference's ring).
    Where the layers split over "model" (`_tp`) the stream stays whole:
    every product runs on the rank's stored columns, the (B, 1, ·) outputs
    gathered over "model" (`transformer._all_cols`), and every rank updates
    every head's SSD state and conv inputs in its replicated cache, so no
    state moves between ranks."""
    execution.torch_device()
    if published(cfg):
        return _published_decode(params, token, cache, cfg)
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    tp = _tp(params, cfg)
    x = transformer._embed_rows(params, token[:, None], cdt)                  # (B, 1, d)
    b = x.shape[0]
    shared = _decode_shared(blocks.cast(params["shared"], cdt), tp)
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
        lp = blocks.cast(blocks.layer_params(params, i), cdt)
        y, ssm_st, conv_st = mamba_block(lp, x, cfg, cache["ssm"][i], cache["conv"][i], tp,
                                         every_head=True)
        cache["ssm"][i] = ssm_st
        cache["conv"][i] = conv_st
        x = x + y
        if i % every == 0:
            h = blocks.rms_norm(torch.cat([x, x0], dim=-1), shared["ln1"], cfg.norm_eps)
            q, k, vv = _qkv(shared, h, cfg, positions)
            k_c, v_c = cache["k"][i // every], cache["v"][i // every]
            if owner == shard[1]:
                k_c[:, j] = k[:, 0].to(k_c.dtype)
                v_c[:, j] = vv[:, 0].to(v_c.dtype)
            attn = blocks.decode_attention(q, k_c, v_c, new_len, window=cfg.sliding_window,
                                           seq_shard=shard)
            x = x + shared["wo"](attn.reshape(b, 1, -1))
            h2 = blocks.rms_norm(torch.cat([x, x0], dim=-1), shared["ln2"], cfg.norm_eps)
            x = x + _mlp(shared, h2, cfg)
    x = blocks.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = transformer._logits(params, x[:, 0], cfg, cdt)
    new_cache = {"ssm": cache["ssm"], "conv": cache["conv"], "k": cache["k"], "v": cache["v"],
                 "len": torch.tensor(new_len, dtype=torch.int32),
                 "pos": torch.tensor(pos + 1, dtype=torch.int32)}
    return logits, new_cache


# ---------------------------------------------------------------------------
# Zamba2's published layout (`SharedBlocksSpec`, `GroupedSSMSpec`)
# ---------------------------------------------------------------------------
#
# Params: `embed`, `final_norm` (and `lm_head` if the head is not tied);
# `layers`, the Mamba-2 layers stacked [L, ...] as above, B and C in groups
# (`in_proj` d -> [z | x | B (g·ds) | C (g·ds) | dt], the conv over
# x | B | C); `shared`, the blocks stacked [n_blocks, ...]: `ln1` (2d),
# `wq` / `wk` / `wv` (2d -> heads·Dh), `wo` (heads·Dh -> d), `ln2` (d),
# `w_gate_up` (d -> 2·d_ff, the gate's half first), `w_out` (d_ff -> d);
# `hybrid`, each use's own leaves stacked [uses, ...]: the adapter
# `adapter_a` (d -> rank), `adapter_b` (rank -> 2·d_ff) and `proj` (d -> d).
# With x0 the embedding, layer i that is use j of block b = j % n_blocks:
#     T = w_out(gelu(gu[:f]) · gu[f:]),  gu = g·w_gate_up + (g·A_j)·B_j,
#     g = norm(Wo·attn(norm(cat(x, x0)))),   u = x + T·proj_j,
# else u = x; then x ← x + Mamba_i(norm(u)).  One rank only: the split over
# "model" is the JAX package's layout's.


def published(cfg: ArchConfig) -> bool:
    """Whether `cfg` is Zamba2's published layout (the port's own specs)."""
    return isinstance(cfg.hybrid, SharedBlocksSpec)


DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 0.1, 1e-4   # Zamba2's time_step_min / _max / _floor


def _dt_bias(gen: torch.Generator, nh: int) -> torch.Tensor:
    """Mamba-2's dt bias: dt log-uniform in [DT_MIN, DT_MAX], at least
    DT_FLOOR, through softplus's inverse (f32)."""
    u = torch.rand((nh,), generator=gen, dtype=torch.float32, device=gen.device)
    dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
    dt = torch.clamp(dt, min=DT_FLOOR)
    return dt + torch.log(-torch.expm1(-dt))


def _published_init(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Params:
    """Mamba-2's init for the mixers (A from [1, 16], D ones, the dt bias
    from Zamba2's time-step range), N(0, 1/d_in) for the products, output
    projections at 1/sqrt(2·L·d_in), ones for the norms."""
    d, dh, hq, hkv, f = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    spec, hyb, n_l = cfg.ssm, cfg.hybrid, cfg.n_layers
    di, nh, ds, g = spec.d_inner(d), spec.n_heads(d), spec.d_state, spec.n_groups
    conv_ch = di + 2 * g * ds

    def dense(d_in, d_out, scale=None):
        return blocks.dense_init(gen, d_in, d_out, dtype, scale).to(device)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    def mamba(_):
        conv_w = torch.randn((spec.d_conv, 1, conv_ch), generator=gen, dtype=torch.float32,
                             device=gen.device) / math.sqrt(spec.d_conv)
        a = torch.rand((nh,), generator=gen, dtype=torch.float32, device=gen.device) * 15 + 1
        return {"ln": ones(d), "in_proj": dense(d, 2 * di + 2 * g * ds + nh),
                "conv_w": conv_w.to(dtype).to(device),
                "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
                "a_log": torch.log(a).to(dtype=dtype, device=device),
                "d_skip": ones(nh), "dt_bias": _dt_bias(gen, nh).to(dtype).to(device),
                "norm_y": ones(di), "out_proj": dense(di, d, 1.0 / math.sqrt(2 * n_l * di))}

    def block(_):
        return {"ln1": ones(2 * d), "wq": dense(2 * d, hq * dh), "wk": dense(2 * d, hkv * dh),
                "wv": dense(2 * d, hkv * dh), "wo": dense(hq * dh, d), "ln2": ones(d),
                "w_gate_up": dense(d, 2 * f), "w_out": dense(f, d)}

    def use(_):
        return {"adapter_a": dense(d, hyb.adapter_rank),
                "adapter_b": dense(hyb.adapter_rank, 2 * f),
                "proj": dense(d, d, 1.0 / math.sqrt(2 * n_l * d))}

    out = {"embed": dense(cfg.padded_vocab, d, scale=1.0),
           "layers": blocks.stacked(mamba, n_l),
           "shared": blocks.stacked(block, hyb.n_blocks),
           "hybrid": blocks.stacked(use, len(hyb.layer_ids)),
           "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        out["lm_head"] = dense(d, cfg.padded_vocab)
    return out


def _published_check(params: Params, cfg: ArchConfig) -> None:
    if not isinstance(params["layers"]["in_proj"], torch.Tensor):
        raise NotImplementedError(f"{cfg.name}: the published Zamba2 layout runs on one rank")


def _use_block(cfg: ArchConfig, j: int) -> int:
    """The shared block that use j runs."""
    return j % cfg.hybrid.n_blocks


def _cast_blocks(params: Params, cfg: ArchConfig, cdt: torch.dtype) -> List[Params]:
    """Each shared block's leaves in the compute dtype, cast once a step."""
    return [blocks.cast({k: t[i] for k, t in params["shared"].items()}, cdt)
            for i in range(cfg.hybrid.n_blocks)]


def _use_params(params: Params, cfg: ArchConfig, j: int, cdt: torch.dtype) -> Params:
    """Use j's adapter and output Linear in the compute dtype."""
    return blocks.cast({k: t[j] for k, t in params["hybrid"].items()}, cdt)


def _published_mlp(sp: Params, hp: Params, g: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The shared MLP of the normed attention output g: gate_up with use j's
    adapter added, exact GELU on the gate's half times the other, then
    `w_out`."""
    gu = g @ sp["w_gate_up"] + (g @ hp["adapter_a"]) @ hp["adapter_b"]
    f = cfg.d_ff
    return (blocks.act_fn(cfg.act)(gu[..., :f]) * gu[..., f:]) @ sp["w_out"]


def _attn_scale(cfg: ArchConfig) -> float:
    """(Dh / 2)^-1/2, HF's `Zamba2Attention` scale."""
    return 1.0 / math.sqrt(cfg.dh / 2)


def _published_tail(sp: Params, hp: Params, x: torch.Tensor, attn: torch.Tensor,
                    cfg: ArchConfig) -> torch.Tensor:
    """u = x + T·proj_j from the attention's heads `attn` (B, S, heads·Dh)."""
    g = blocks.rms_norm(attn @ sp["wo"], sp["ln2"], cfg.norm_eps)
    return x + _published_mlp(sp, hp, g, cfg) @ hp["proj"]


def _published_prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
                       cache_size: int, dev: torch.device, backend: str):
    """`prefill` of the published layout: the shared blocks cast once, each
    use's attention through B4 at (Dh / 2)^-1/2, its keys and values into
    the use's cache slot."""
    _published_check(params, cfg)
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    x = transformer._embed_rows(params, batch["tokens"], cdt)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    shared = _cast_blocks(params, cfg, cdt)
    uses = {lid: j for j, lid in enumerate(cfg.hybrid.layer_ids)}
    cache = init_cache(cfg, b, cache_size, dev)
    n = min(s, cache["k"].shape[2])
    x0 = x
    for i in range(cfg.n_layers):
        u = x
        if i in uses:
            j = uses[i]
            with obs.span("zamba.shared"):
                sp, hp = shared[_use_block(cfg, j)], _use_params(params, cfg, j, cdt)
                h = blocks.rms_norm(torch.cat([x, x0], dim=-1), sp["ln1"], cfg.norm_eps)
                q, k, vv = _qkv(_matrices(sp), h, cfg, positions)
                attn = blocks.flash_attention(q, k, vv, causal=True, q_chunk=cfg.q_chunk,
                                              kv_chunk=cfg.kv_chunk, backend=backend,
                                              scale=_attn_scale(cfg))
                u = _published_tail(sp, hp, x, attn.reshape(b, s, -1), cfg)
            cache["k"][j, :, :n] = k[:, s - n:]
            cache["v"][j, :, :n] = vv[:, s - n:]
        lp = blocks.cast(blocks.layer_params(params, i), cdt)
        y, cache["ssm"][i], cache["conv"][i] = mamba_block(lp, u, cfg,
                                                           _zero_ssm_state(cfg, b, x.device), None)
        x = x + y
    x = blocks.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = transformer._logits(params, x, cfg, cdt)
    cache["len"] = torch.tensor(n, dtype=torch.int32)
    cache["pos"] = torch.tensor(s, dtype=torch.int32)
    return logits[:, 0], cache


def _matrices(sp: Params) -> Params:
    """The block's q / k / v products as `_qkv` calls them."""
    return {k: _times(sp[k]) for k in ("wq", "wk", "wv")}


def _published_decode(params: Params, token: torch.Tensor, cache: Dict[str, torch.Tensor],
                      cfg: ArchConfig):
    """`decode_step` of the published layout, the cache written in place;
    the K/V slot is `len` while the cache fills, then `pos % S`."""
    _published_check(params, cfg)
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    x = transformer._embed_rows(params, token[:, None], cdt)                  # (B, 1, d)
    b = x.shape[0]
    shared = _cast_blocks(params, cfg, cdt)
    uses = {lid: j for j, lid in enumerate(cfg.hybrid.layer_ids)}
    s_max = cache["k"].shape[2]
    pos, n = int(cache["pos"]), int(cache["len"])
    slot = n if n < s_max else pos % s_max
    new_len = min(n + 1, s_max)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    x0 = x
    for i in range(cfg.n_layers):
        u = x
        if i in uses:
            j = uses[i]
            with obs.span("zamba.shared"):
                sp, hp = shared[_use_block(cfg, j)], _use_params(params, cfg, j, cdt)
                h = blocks.rms_norm(torch.cat([x, x0], dim=-1), sp["ln1"], cfg.norm_eps)
                q, k, vv = _qkv(_matrices(sp), h, cfg, positions)
                k_c, v_c = cache["k"][j], cache["v"][j]
                k_c[:, slot] = k[:, 0].to(k_c.dtype)
                v_c[:, slot] = vv[:, 0].to(v_c.dtype)
                attn = blocks.decode_attention(q, k_c, v_c, new_len, scale_dh=cfg.dh // 2)
                u = _published_tail(sp, hp, x, attn.reshape(b, 1, -1), cfg)
        lp = blocks.cast(blocks.layer_params(params, i), cdt)
        y, ssm_st, conv_st = mamba_block(lp, u, cfg, cache["ssm"][i], cache["conv"][i])
        cache["ssm"][i] = ssm_st
        cache["conv"][i] = conv_st
        x = x + y
    x = blocks.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = transformer._logits(params, x[:, 0], cfg, cdt)
    new_cache = {"ssm": cache["ssm"], "conv": cache["conv"], "k": cache["k"], "v": cache["v"],
                 "len": torch.tensor(new_len, dtype=torch.int32),
                 "pos": torch.tensor(pos + 1, dtype=torch.int32)}
    return logits, new_cache
