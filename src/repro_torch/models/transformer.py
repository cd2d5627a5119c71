"""Config-driven dense decoder LM: GQA + RoPE (+ SWA), text tokens only.

The port of the JAX package's `models/transformer.py` for serving:
`init_params`, `prefill`, `decode_step`, and `hidden_states` / `forward`
for the tests.  Parameters are a plain dict with the reference's keys and
its stacked `[L, ...]` layer layout, so `bridge.params_from_reference`
maps the JAX pytree leaf by leaf; the layer stack is a Python loop in place
of `lax.scan`.  Attention's forward goes through the CUDA kernel when the
`Execution` says `backend="kernel"`.

MoE layers, modality front-ends (with or without the DR front-end) and the
RP-compressed KV cache raise `NotImplementedError` (ROADMAP A9b, A9d,
A9c).  The mesh constraint of the reference's layer body is dropped: one
card has no mesh (ROADMAP A10).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.execution import Execution
from repro_torch.models import blocks
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the options of the reference this port does not run yet."""
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE layers are not ported yet (ROADMAP A9b)")
    if cfg.kv_rp is not None:
        raise NotImplementedError(
            f"{cfg.name}: the RP-compressed KV cache (kv_rp) is not ported yet (ROADMAP A9c)")
    if cfg.frontend is not None or cfg.dr_frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: modality front-ends ({cfg.frontend}) are not ported yet (ROADMAP A9d)")


def _cast(lp: Params, cdt: torch.dtype) -> Params:
    """The reference's cast rule: f32 leaves with ndim >= 2 -> compute dtype."""
    return {k: (t.to(cdt) if t.dtype == torch.float32 and t.ndim >= 2 else t)
            for k, t in lp.items()}


def _layer_params(params: Params, i: int) -> Params:
    return {k: t[i] for k, t in params["layers"].items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ArchConfig, *,
                device: torch.device = None) -> Params:
    """Random params drawn from `gen` (on the generator's device), placed on
    `device` (default: the generator's)."""
    cfg.validate()
    check_supported(cfg)
    dtype = torch_dtype(cfg.param_dtype)
    d, dh = cfg.d_model, cfg.dh
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    v = cfg.padded_vocab
    device = gen.device if device is None else device

    def dense(d_in, d_out, scale=None):
        return blocks.dense_init(gen, d_in, d_out, dtype, scale).to(device)

    def layer_init(i):
        p = {
            "ln1": torch.ones((d,), dtype=dtype, device=device),
            "ln2": torch.ones((d,), dtype=dtype, device=device),
            "wq": dense(d, hq * dh),
            "wk": dense(d, hkv * dh),
            "wv": dense(d, hkv * dh),
            "wo": dense(hq * dh, d, scale=1.0 / math.sqrt(2 * cfg.n_layers * hq * dh)),
        }
        f = cfg.d_ff
        p["w_in"] = dense(d, f)
        if cfg.gated_mlp:
            p["w_gate"] = dense(d, f)
        p["w_out"] = dense(f, d, scale=1.0 / math.sqrt(2 * cfg.n_layers * f))
        return p

    params = {
        "embed": dense(v, d, scale=1.0),
        "layers": blocks.stacked(layer_init, cfg.n_layers),
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, v)
    return params


# ---------------------------------------------------------------------------
# layer body (shared by the full forward and prefill)
# ---------------------------------------------------------------------------

def _attn_proj(lp, x, cfg: ArchConfig, positions):
    b, s, _ = x.shape
    dh, hq, hkv = cfg.dh, cfg.n_heads, cfg.n_kv_heads
    q = (x @ lp["wq"]).reshape(b, s, hq, dh)
    k = (x @ lp["wk"]).reshape(b, s, hkv, dh)
    vv = (x @ lp["wv"]).reshape(b, s, hkv, dh)
    if cfg.causal:  # decoder LMs use RoPE; the encoder stub keeps raw proj
        q = blocks.apply_rope(q, positions, cfg.rope_theta)
        k = blocks.apply_rope(k, positions, cfg.rope_theta)
    return q, k, vv


def _mlp_params(lp):
    return {k: lp[k] for k in ("w_in", "w_gate", "w_out") if k in lp}


def _layer(lp: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
           backend: str):
    """One block on the full sequence -> (x, (k, v))."""
    b, s, _ = x.shape
    h = blocks.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, vv = _attn_proj(lp, h, cfg, positions)
    attn = blocks.flash_attention(
        q, k, vv, causal=cfg.causal, window=cfg.sliding_window,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk, backend=backend)
    x = x + (attn.reshape(b, s, -1) @ lp["wo"])
    h = blocks.rms_norm(x, lp["ln2"], cfg.norm_eps)
    x = x + blocks.mlp(_mlp_params(lp), h, cfg.act)
    return x, (k, vv)


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------

def embed_inputs(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
                 compute_dtype: torch.dtype) -> Tuple[torch.Tensor, int]:
    """Returns (x (B, S, d), n_prefix); the token path only, so n_prefix is
    always 0."""
    check_supported(cfg)
    tok = batch["tokens"].to(device=params["embed"].device, dtype=torch.long)
    return params["embed"][tok].to(compute_dtype), 0


def _head(params: Params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# full forward (tests / small-scale use)
# ---------------------------------------------------------------------------

def hidden_states(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
                  execution: Execution = Execution()) -> torch.Tensor:
    """Full-sequence backbone -> final normed hidden (B, S, d)."""
    execution.torch_device()
    cdt = torch_dtype(cfg.compute_dtype)
    x, _ = embed_inputs(params, batch, cfg, cdt)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    for i in range(cfg.n_layers):
        x, _ = _layer(_cast(_layer_params(params, i), cdt), x, cfg, positions,
                      execution.backend)
    return blocks.rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            execution: Execution = Execution()) -> torch.Tensor:
    """Full logits (B, S, V) in f32."""
    x = hidden_states(params, batch, cfg, execution=execution)
    cdt = torch_dtype(cfg.compute_dtype)
    return (x @ _head(params, cfg).to(cdt)).to(torch.float32)


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, cache_size: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Zero cache: {"k", "v": (L, B, keep, Hkv, Dh) in the compute dtype,
    "len", "pos": int32 scalars on the host}, where the window bounds
    `keep` under SWA."""
    check_supported(cfg)
    win = cfg.sliding_window
    keep = min(cache_size, win) if win else cache_size
    shape = (cfg.n_layers, batch, keep, cfg.n_kv_heads, cfg.dh)
    cdt = torch_dtype(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device),
            "len": torch.tensor(0, dtype=torch.int32),
            "pos": torch.tensor(0, dtype=torch.int32)}


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            cache_size: int, *, execution: Execution = Execution()
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Runs the prompt, returns (last-position logits (B, V) f32, kv cache
    as `init_cache` lays it out).  As in the reference, the last `keep` keys
    of the prompt sit at slots 0..keep-1 (ring start at 0 = the oldest kept
    position)."""
    execution.torch_device()
    cdt = torch_dtype(cfg.compute_dtype)
    x, _ = embed_inputs(params, batch, cfg, cdt)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    cache = init_cache(cfg, b, cache_size, x.device)
    n = min(s, cache["k"].shape[2])
    for i in range(cfg.n_layers):
        x, (k, vv) = _layer(_cast(_layer_params(params, i), cdt), x, cfg, positions,
                            execution.backend)
        cache["k"][i, :, :n] = k[:, s - n:]
        cache["v"][i, :, :n] = vv[:, s - n:]
    x = blocks.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (x @ _head(params, cfg).to(cdt)).to(torch.float32)
    cache["len"] = torch.tensor(n, dtype=torch.int32)
    cache["pos"] = torch.tensor(s, dtype=torch.int32)
    return logits[:, 0], cache


def decode_step(params: Params, token: torch.Tensor, cache: Dict[str, torch.Tensor],
                cfg: ArchConfig, *, execution: Execution = Execution()
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token: token (B,) int -> (logits (B, V) f32, updated cache).

    The new key and value are written into the given cache's `k` / `v`
    tensors in place (the reference donates the cache to the same effect);
    the returned dict holds those tensors and the advanced `len` / `pos`.
    The slot is `len` while the cache fills, then `pos % S` (the
    reference's ring)."""
    execution.torch_device()
    check_supported(cfg)
    cdt = torch_dtype(cfg.compute_dtype)
    embed = params["embed"]
    x = embed[token.to(device=embed.device, dtype=torch.long)[:, None]].to(cdt)  # (B,1,d)
    b = x.shape[0]
    k_c, v_c = cache["k"], cache["v"]
    s_max = k_c.shape[2]
    pos, n = int(cache["pos"]), int(cache["len"])
    slot = n if n < s_max else pos % s_max
    new_len = min(n + 1, s_max)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        lp = _cast(_layer_params(params, i), cdt)
        h = blocks.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, vv = _attn_proj(lp, h, cfg, positions)
        k_c[i, :, slot] = k[:, 0].to(k_c.dtype)
        v_c[i, :, slot] = vv[:, 0].to(v_c.dtype)
        attn = blocks.decode_attention(q, k_c[i], v_c[i], new_len,
                                       window=cfg.sliding_window, scale_dh=cfg.dh)
        x = x + attn.reshape(b, 1, -1) @ lp["wo"]
        h2 = blocks.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + blocks.mlp(_mlp_params(lp), h2, cfg.act)
    x = blocks.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ _head(params, cfg).to(cdt)).to(torch.float32)
    new_cache = {"k": k_c, "v": v_c,
                 "len": torch.tensor(new_len, dtype=torch.int32),
                 "pos": torch.tensor(pos + 1, dtype=torch.int32)}
    return logits, new_cache
