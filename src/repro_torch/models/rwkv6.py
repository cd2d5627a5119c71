"""RWKV-6 "Finch": an attention-free LM with data-dependent per-channel decay.

The port of the JAX package's `models/rwkv6.py`: `init_params`,
`init_state`, `loss_fn` over `hidden_states` (each layer under checkpoint
with `remat`), `forward`, and the serving steps `prefill` / `decode_step`.  Per layer a time-mix block (the WKV6 recurrence over a per-head
(Dh × Dh) state) and a channel-mix block; heads are d_model / 64.  The
decode state is O(1) in the sequence length: the WKV matrices, the two
token-shift inputs of each layer and the position, no KV cache.

Parameters are a plain dict with the reference's keys and its stacked
`[L, ...]` layout (`bridge.params_from_reference` maps the JAX pytree leaf
by leaf); the layer stack is a Python loop in place of `lax.scan`, and the
reference's mesh pins are dropped (the model code runs on local tensors; on
a mesh each layer body gathers its own leaves, `blocks.gather_layer`).  The WKV
recurrence is a step loop in plain PyTorch, as the reference's is a
`lax.scan` outside any Pallas kernel: r, k, v, w and g are computed for the
whole sequence first, and only the state update and the read-out run per
step.  As in the reference, a sequence that is a multiple of `WKV_CHUNK`
longer than one chunk runs chunk by chunk, each chunk under checkpoint
when grad is needed, so the backward keeps one state per chunk instead of
one per step; the arithmetic is the same either way.  The backward is
autograd through the step loop.

Rounding follows the reference: every f32 layer leaf is cast to the
compute dtype as the reference casts its stacked leaves (norms, mixes,
`w_base`, `u_bonus` too); w is rounded to the compute dtype before it is
widened to f32 for the scan; the state and k vᵀ are f32; each step's
output is rounded to r's dtype; the token-shift states hold each mix's
normed input in the compute dtype.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.core.execution import Execution
from repro_torch.models import blocks
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]
HEAD_DIM = 64
LORA_RANK = 64   # the decay LoRA's rank, fixed as in the reference


def init_params(gen: torch.Generator, cfg: ArchConfig, *,
                device: torch.device = None) -> Params:
    """Random params drawn from `gen` (on the generator's device), placed on
    `device` (default: the generator's); the deterministic leaves (norms,
    mixes, `w_base`, `u_bonus`) equal the reference's."""
    cfg.validate()
    dtype = blocks.torch_dtype(cfg.param_dtype)
    d, f = cfg.d_model, cfg.d_ff
    nh = d // HEAD_DIM
    v = cfg.padded_vocab
    device = gen.device if device is None else device

    def dense(d_in, d_out, scale=None):
        return blocks.dense_init(gen, d_in, d_out, dtype, scale).to(device)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def layer_init(i):
        return {
            "ln1": full((d,), 1.0), "ln2": full((d,), 1.0),
            "mix_r": full((d,), 0.5), "mix_k": full((d,), 0.5),
            "mix_v": full((d,), 0.5), "mix_g": full((d,), 0.5),
            "mix_w": full((d,), 0.5),
            "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d), "wg": dense(d, d),
            "wo": dense(d, d, scale=1.0 / math.sqrt(2 * cfg.n_layers * d)),
            # data-dependent decay: w_t = exp(-exp(base + lora(x)))
            "w_base": full((d,), -0.6),
            "w_lora_a": dense(d, LORA_RANK),
            "w_lora_b": dense(LORA_RANK, d, scale=1e-2),
            "u_bonus": full((nh, HEAD_DIM), 0.0),
            "ln_x": full((d,), 1.0),
            "cmix_r": full((d,), 0.5), "cmix_k": full((d,), 0.5),
            "cm_r": dense(d, d), "cm_k": dense(d, f),
            "cm_v": dense(f, d, scale=1.0 / math.sqrt(2 * cfg.n_layers * f)),
        }

    return {
        "embed": dense(v, d, scale=1.0),
        "layers": blocks.stacked(layer_init, cfg.n_layers),
        "final_norm": full((d,), 1.0),
        "lm_head": dense(d, v),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> x_{t-1} with prev (B, d) as the t=0 predecessor."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


WKV_CHUNK = 64  # time steps per checkpointed chunk of the recurrence


def _wkv_steps(r32, k32, v32, w, u4, state, dtype):
    """The recurrence over the given steps, operands in f32; outputs
    rounded to `dtype`, stacked on the time axis."""
    outs = []
    for t in range(r32.shape[1]):
        kv = k32[:, t, :, :, None] * v32[:, t, :, None, :]      # (B, H, Dh, Dh), exact
        outs.append((r32[:, t, :, None, :] @ (state + u4 * kv))[:, :, 0].to(dtype))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state


def _wkv_scan(r, k, v, w, u, state0):
    """WKV6: per-head rank-1 state updates.

    r, k, v (B, S, H, Dh) in the compute dtype, w (B, S, H, Dh) and u (H, Dh)
    in f32, state0 (B, H, Dh, Dh) f32 (not written).
    out_t = rᵀ(S + u⊙k vᵀ);  S ← diag(w_t) S + k_t v_tᵀ.
    Returns (out (B, S, H, Dh) in r's dtype, final state).  A sequence that
    is a multiple of WKV_CHUNK and longer than one chunk runs chunk by
    chunk (`blocks.remat`: checkpointed when grad is needed)."""
    s = r.shape[1]
    args = (r.to(torch.float32), k.to(torch.float32), v.to(torch.float32), w)
    u4 = u[None, :, :, None]
    if s % WKV_CHUNK != 0 or s <= WKV_CHUNK:
        return _wkv_steps(*args, u4, state0, r.dtype)
    outs, state = [], state0
    for c0 in range(0, s, WKV_CHUNK):
        out, state = blocks.remat(_wkv_steps, *(t[:, c0:c0 + WKV_CHUNK] for t in args), u4,
                                  state, r.dtype)
        outs.append(out)
    return torch.cat(outs, dim=1), state


def _time_mix(lp, x, prev_x, state, cfg: ArchConfig, nh: int):
    """x: the layer's normed input (B, S, d) -> (out, x[:, -1], new wkv state)."""
    b, s, d = x.shape
    xp = _token_shift(x, prev_x)

    def mix(name):
        m = lp[name].to(x.dtype)
        return x * m + xp * (1.0 - m)

    r = (mix("mix_r") @ lp["wr"]).reshape(b, s, nh, HEAD_DIM)
    k = (mix("mix_k") @ lp["wk"]).reshape(b, s, nh, HEAD_DIM)
    v = (mix("mix_v") @ lp["wv"]).reshape(b, s, nh, HEAD_DIM)
    g = blocks.act_fn("silu")(mix("mix_g") @ lp["wg"])
    # data-dependent decay, summed in w_base's dtype (the compute dtype)
    w_log = lp["w_base"] + torch.tanh(mix("mix_w") @ lp["w_lora_a"]) @ lp["w_lora_b"]
    w = torch.exp(-torch.exp(w_log.to(torch.float32))).to(x.dtype)
    w = w.reshape(b, s, nh, HEAD_DIM)
    out, state = _wkv_scan(r, k, v, w.to(torch.float32), lp["u_bonus"].to(torch.float32),
                           state)
    out = out.reshape(b, s, d).to(x.dtype)
    out = blocks.rms_norm(out, lp["ln_x"], cfg.norm_eps) * g
    return out @ lp["wo"], x[:, -1], state


def _channel_mix(lp, x, prev_x):
    xp = _token_shift(x, prev_x)
    cr = lp["cmix_r"].to(x.dtype)
    ck = lp["cmix_k"].to(x.dtype)
    r = blocks.sigmoid((x * cr + xp * (1 - cr)) @ lp["cm_r"])
    k = (x * ck + xp * (1 - ck)) @ lp["cm_k"]
    return r * (torch.square(F.relu(k)) @ lp["cm_v"]), x[:, -1]


def init_state(cfg: ArchConfig, batch: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Zero decode state: {"wkv": (L, B, H, Dh, Dh) f32, "shift_t",
    "shift_c": (L, B, d) in the compute dtype, "pos": int32 scalar on the
    host}."""
    nh = cfg.d_model // HEAD_DIM
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    shift = (cfg.n_layers, batch, cfg.d_model)
    return {
        "wkv": torch.zeros((cfg.n_layers, batch, nh, HEAD_DIM, HEAD_DIM),
                           dtype=torch.float32, device=device),
        "shift_t": torch.zeros(shift, dtype=cdt, device=device),
        "shift_c": torch.zeros(shift, dtype=cdt, device=device),
        "pos": torch.tensor(0, dtype=torch.int32),
    }


def _block(lp, x, cfg: ArchConfig, nh: int, wkv0, sh_t0, sh_c0):
    """One layer from its states -> (x, wkv, shift_t, shift_c)."""
    h = blocks.rms_norm(x, lp["ln1"], cfg.norm_eps)
    dt, sh_t, wkv = _time_mix(lp, h, sh_t0.to(x.dtype), wkv0, cfg, nh)
    x = x + dt
    h = blocks.rms_norm(x, lp["ln2"], cfg.norm_eps)
    dc, sh_c = _channel_mix(lp, h, sh_c0.to(x.dtype))
    return x + dc, wkv, sh_t, sh_c


def hidden_states(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
                  remat: bool = True, execution: Execution = Execution(),
                  state: Dict[str, torch.Tensor] = None):
    """Backbone pass -> (final normed hidden (B, S, d), aux {}, new state).

    A given `state`'s tensors are overwritten with the new state (the
    serving steps).  Without one the layers start from zero states and the
    new state is built from their outputs, nothing written in place, so
    autograd can run through it (the training forward: with `remat` each
    layer under checkpoint, its leaves cast inside the checkpointed
    body)."""
    dev = execution.torch_device()
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    x = blocks.embed(params, batch["tokens"], cdt)
    b = x.shape[0]
    nh = cfg.d_model // HEAD_DIM
    fresh = state is None
    zeros = init_state(cfg, b, dev) if fresh else None
    pos = 0 if fresh else int(state["pos"])

    def body(x, lp, wkv0, sh_t0, sh_c0):
        return _block(blocks.cast_stacked(blocks.gather_layer(lp), cdt), x, cfg, nh, wkv0,
                      sh_t0, sh_c0)

    outs = []
    for i, lp in enumerate(blocks.unstacked(params)):
        src = zeros if fresh else state
        args = (x, lp, src["wkv"][i], src["shift_t"][i], src["shift_c"][i])
        x, wkv, sh_t, sh_c = blocks.remat(body, *args) if remat else body(*args)
        if fresh:
            outs.append((wkv, sh_t, sh_c))
        else:
            state["wkv"][i] = wkv
            state["shift_t"][i] = sh_t
            state["shift_c"][i] = sh_c
    x = blocks.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if fresh:
        state = {name: torch.stack(ts) for name, ts in
                 zip(("wkv", "shift_t", "shift_c"), zip(*outs))}
    new_state = {"wkv": state["wkv"], "shift_t": state["shift_t"], "shift_c": state["shift_c"],
                 "pos": torch.tensor(pos + x.shape[1], dtype=torch.int32)}
    return x, {}, new_state


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            remat: bool = True, execution: Execution = Execution()):
    """(mean next-token NLL, {"ce": it}) from zero states."""
    x, _, _ = hidden_states(params, batch, cfg, remat=remat, execution=execution)
    targets = batch["tokens"][:, 1:]
    loss = blocks.chunked_softmax_xent(x[:, :-1], params["lm_head"], targets)
    return loss, {"ce": loss}


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            execution: Execution = Execution(), state: Dict[str, torch.Tensor] = None):
    """(full logits (B, S, V) in f32, aux, final state)."""
    x, aux, new_state = hidden_states(params, batch, cfg, execution=execution, state=state)
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    return (x @ params["lm_head"].to(cdt)).to(torch.float32), aux, new_state


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            cache_size: int = 0, *, execution: Execution = Execution()):
    """Runs the prompt from a zero state -> (last-position logits (B, V) f32,
    decode state as `init_state` lays it out).  The head runs on the last
    position only (the reference slices it from the full logits);
    `cache_size` is unused: the state does not grow with the sequence."""
    x, _, state = hidden_states(params, batch, cfg, execution=execution)
    cdt = x.dtype
    return (x[:, -1] @ params["lm_head"].to(cdt)).to(torch.float32), state


def decode_step(params: Params, token: torch.Tensor, state: Dict[str, torch.Tensor],
                cfg: ArchConfig, *, execution: Execution = Execution()):
    """One token through the recurrence: token (B,) int -> (logits (B, V)
    f32, new state).  The given state's `wkv`, `shift_t` and `shift_c`
    tensors are overwritten in place (the reference donates the state to
    the same effect); the returned dict holds them and the advanced `pos`."""
    x, _, state = hidden_states(params, {"tokens": token[:, None]}, cfg,
                                execution=execution, state=state)
    cdt = x.dtype
    return (x[:, 0] @ params["lm_head"].to(cdt)).to(torch.float32), state
