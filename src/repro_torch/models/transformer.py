"""Config-driven transformer LM: GQA + RoPE (+ SWA, MoE, encoder, VLM/audio).

The port of the JAX package's `models/transformer.py`: `init_params`,
`loss_fn` and its training forward `hidden_states` (each layer under
checkpoint with `remat`, as the reference's `jax.checkpoint` over the
scanned body), `forward` for the tests, and the serving steps `prefill` /
`decode_step`.  Parameters are a plain dict with the reference's keys and
its stacked `[L, ...]` layer layout, so `bridge.params_from_reference`
maps the JAX pytree leaf by leaf; the layer stack is a Python loop in place
of `lax.scan`.  Attention's forward goes through the CUDA kernel when the
`Execution` says `backend="kernel"`; its backward is the plain chunked one
(`blocks.FlashAttentionFn`).

Every option of the reference's transformer runs: MoE layers (the
single-device capacity dispatch, `blocks.moe_layer`), the audio and vision
front-ends (`embed_inputs`; with a DR front-end the caller reduces the raw
features first, `train.train_step._apply_dr_frontend`) and the
RP-compressed KV cache (`kv_rp`).  The mesh constraint of the reference's
layer body has no counterpart: the port's meshed steps hand the model code
local tensors, on which a layout hint pins nothing.  On a mesh each layer
body gathers its own leaves from the rank's shards (`blocks.gather_layer`;
the MoE expert stacks are gathered by `blocks.moe_layer`), and the serving
steps keep the K/V cache's slots split over "model"
(`dist.sharding.kv_seq_shard`): prefill writes each rank's slot range,
decode writes the new key on the rank that owns its slot and attends over
the rank's own slots (`blocks.decode_attention`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import random_projection as rp_mod
from repro_torch.core.execution import Execution
from repro_torch.dist import sharding as shard_rules
from repro_torch.models import blocks
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]

_MOE_KEYS = ("router", "w_in", "w_gate", "w_out")


# ---------------------------------------------------------------------------
# init
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

    def dense(d_in, d_out, scale=None, dt=dtype):
        return blocks.dense_init(gen, d_in, d_out, dt, scale).to(device)

    def experts(d_in, d_out, scale=None):
        # drawn expert by expert into one (E, d_in, d_out) tensor, so a
        # layer's experts never exist twice
        w = torch.empty((cfg.moe.n_experts, d_in, d_out), dtype=dtype, device=device)
        for j in range(cfg.moe.n_experts):
            w[j] = dense(d_in, d_out, scale)
        return w

    def layer_init(i):
        p = {
            "ln1": torch.ones((d,), dtype=dtype, device=device),
            "ln2": torch.ones((d,), dtype=dtype, device=device),
            "wq": dense(d, hq * dh),
            "wk": dense(d, hkv * dh),
            "wv": dense(d, hkv * dh),
            "wo": dense(hq * dh, d, scale=1.0 / math.sqrt(2 * cfg.n_layers * hq * dh)),
        }
        if cfg.moe is not None:
            e, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
            p["router"] = dense(d, e, dt=torch.float32)
            p["w_in"] = experts(d, f)
            p["w_gate"] = experts(d, f)
            p["w_out"] = experts(f, d, scale=1.0 / math.sqrt(2 * cfg.n_layers * f))
        else:
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
    if cfg.frontend is not None:
        # with a DR front-end the projection reads the REDUCED features
        f_in = cfg.dr_frontend.n if cfg.dr_frontend is not None else cfg.frontend_dim
        params["frontend_proj"] = dense(f_in, d)
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


def _gathered(lp: Params, cfg: ArchConfig) -> Params:
    """A layer's leaves gathered from a rank's shards, the MoE expert
    stacks left to `blocks.moe_layer`."""
    return blocks.gather_layer(lp, keep=blocks.EXPERT_KEYS if cfg.moe is not None else ())


def _ffn(lp: Params, h: torch.Tensor, cfg: ArchConfig):
    """The layer's MLP or MoE on normed h -> (y, aux)."""
    if cfg.moe is not None:
        return blocks.moe_layer({k: lp[k] for k in _MOE_KEYS}, h, cfg.moe, cfg.act)
    y = blocks.mlp({k: lp[k] for k in ("w_in", "w_gate", "w_out") if k in lp}, h, cfg.act)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    return y, {"moe_lb": zero, "moe_z": zero}


def _layer(lp: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
           backend: str):
    """One block on the full sequence -> (x, aux, (k, v))."""
    b, s, _ = x.shape
    h = blocks.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, vv = _attn_proj(lp, h, cfg, positions)
    attn = blocks.flash_attention(
        q, k, vv, causal=cfg.causal, window=cfg.sliding_window,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk, backend=backend)
    x = x + (attn.reshape(b, s, -1) @ lp["wo"])
    y, aux = _ffn(lp, blocks.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
    return x + y, aux, (k, vv)


# ---------------------------------------------------------------------------
# embedding / front-end
# ---------------------------------------------------------------------------

def embed_inputs(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
                 compute_dtype: torch.dtype) -> Tuple[torch.Tensor, int]:
    """Returns (x (B, S_total, d), n_prefix), where the n_prefix leading
    positions carry modality front-end content: audio frames (B, S, f) run
    through `frontend_proj` in place of the tokens; vision patches (B, P, f)
    are projected and put before the tokens' embeddings."""
    dev = params["embed"].device

    def project(feats):
        return feats.to(device=dev, dtype=compute_dtype) @ \
            params["frontend_proj"].to(compute_dtype)

    if cfg.frontend == "audio":
        return project(batch["frames"]), 0
    x = blocks.embed(params, batch["tokens"], compute_dtype)
    if cfg.frontend == "vision":
        px = project(batch["patches"])
        return torch.cat([px, x], dim=1), px.shape[1]
    return x, 0


def _head(params: Params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# training forward + loss
# ---------------------------------------------------------------------------

def hidden_states(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
                  remat: bool = True, execution: Execution = Execution()
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence backbone -> (final normed hidden (B, S_total, d), aux):
    aux holds `moe_lb` / `moe_z` averaged over the layers and `n_prefix`.

    With `remat` and grad enabled each layer runs under checkpoint, its
    leaves cast to the compute dtype inside the checkpointed body (so the
    compute-dtype copies are remade in the backward, never stored), by the
    reference's rule for the stacked leaves (`blocks.cast_stacked`)."""
    execution.torch_device()
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    x, n_prefix = embed_inputs(params, batch, cfg, cdt)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]

    def body(x, lp):
        x, aux, _ = _layer(blocks.cast_stacked(_gathered(lp, cfg), cdt), x, cfg, positions,
                           execution.backend)
        return x, aux["moe_lb"], aux["moe_z"]

    lb = lz = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in blocks.unstacked(params):
        x, lb_i, lz_i = blocks.remat(body, x, lp) if remat else body(x, lp)
        lb, lz = lb + lb_i, lz + lz_i
    x = blocks.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, {"moe_lb": lb / cfg.n_layers, "moe_z": lz / cfg.n_layers, "n_prefix": n_prefix}


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            remat: bool = True, execution: Execution = Execution()
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, aux): the mean token NLL over the text region (next-token
    targets past the modality prefix for a causal LM; the token at each
    position for the encoder), plus 0.01·moe_lb + moe_z; aux holds `ce`,
    `moe_lb` and `moe_z`."""
    x, aux = hidden_states(params, batch, cfg, remat=remat, execution=execution)
    n_prefix = aux["n_prefix"]
    tokens = batch["tokens"].to(x.device)
    if cfg.causal:
        targets = tokens[:, 1:]
        xs = x[:, n_prefix:n_prefix + targets.shape[1]]
    else:
        targets = tokens
        xs = x[:, :targets.shape[1]]
    loss = blocks.chunked_softmax_xent(xs, _head(params, cfg), targets)
    total = loss + 0.01 * aux["moe_lb"] + aux["moe_z"]
    return total, {"ce": loss, "moe_lb": aux["moe_lb"], "moe_z": aux["moe_z"]}


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            remat: bool = True, execution: Execution = Execution()
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(full logits (B, S_total, V) in f32, aux); tests and small-scale use
    (training takes the chunked loss)."""
    x, aux = hidden_states(params, batch, cfg, remat=remat, execution=execution)
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    return (x @ _head(params, cfg).to(cdt)).to(torch.float32), aux


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

_KV_RP_SEED = 20180615  # the reference's: a serving-time constant


def kv_rp_matrix(cfg: ArchConfig, device: torch.device) -> Optional[torch.Tensor]:
    """The port's ternary JL sketch R (dh, dh // kv_rp) in f32 for key
    compression, or None without `kv_rp`.  PyTorch cannot redraw the
    reference's threefry R, so the port draws its own from the same seed
    on a CPU generator (the same R on every device), with the reference's
    distribution and isometry scale: with s = p, E⟨Rq, Rk⟩ = ⟨q, k⟩, so the
    softmax keeps its 1/sqrt(dh) temperature.  `prefill` / `decode_step`
    take an explicit R in its place (`kv_rp_r`)."""
    if cfg.kv_rp is None:
        return None
    rcfg = rp_mod.RPConfig(m=cfg.dh, p=cfg.dh // cfg.kv_rp, normalize="isometry")
    r = rp_mod.sample_ternary(torch.Generator().manual_seed(_KV_RP_SEED), rcfg)
    return (r.to(torch.float32).T * rcfg.scale).to(device)


def _kv_rp(cfg: ArchConfig, r: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    if cfg.kv_rp is None:
        return None
    return kv_rp_matrix(cfg, device) if r is None else r.to(device=device,
                                                             dtype=torch.float32)


def _sketch_k(k: torch.Tensor, r: Optional[torch.Tensor]) -> torch.Tensor:
    if r is None:
        return k
    return (k.to(torch.float32) @ r).to(k.dtype)   # (..., H, dh_r)


def cache_slots(cfg: ArchConfig, cache_size: int) -> int:
    """The K/V cache's slots: `cache_size`, bounded by the window under SWA."""
    win = cfg.sliding_window
    return min(cache_size, win) if win else cache_size


def init_cache(cfg: ArchConfig, batch: int, cache_size: int,
               device: torch.device, *, seq_shards: int = 1) -> Dict[str, torch.Tensor]:
    """Zero cache: {"k": (L, B, keep, Hkv, Dh_k), "v": (L, B, keep, Hkv,
    Dh) in the compute dtype, "len", "pos": int32 scalars on the host},
    where the window bounds `keep` under SWA and Dh_k = Dh // kv_rp with
    the RP-sketched keys; with `seq_shards` = n, one rank's block of keep /
    n slots."""
    keep = cache_slots(cfg, cache_size) // seq_shards
    dh_k = cfg.dh // cfg.kv_rp if cfg.kv_rp else cfg.dh
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    shape = (cfg.n_layers, batch, keep, cfg.n_kv_heads)
    return {"k": torch.zeros(shape + (dh_k,), dtype=cdt, device=device),
            "v": torch.zeros(shape + (cfg.dh,), dtype=cdt, device=device),
            "len": torch.tensor(0, dtype=torch.int32),
            "pos": torch.tensor(0, dtype=torch.int32)}


def prompt_slots(n: int, slots: int, r: int) -> Tuple[int, int]:
    """(first kept prompt key, count) that block r of `slots` slots holds
    when the n kept keys of a prompt fill global slots 0..n-1."""
    lo = r * slots
    return lo, max(0, min(n, lo + slots) - lo)


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            cache_size: int, *, execution: Execution = Execution(),
            kv_rp_r: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Runs the prompt, returns (last-position logits (B, V) f32, kv cache
    as `init_cache` lays it out).  As in the reference, the last `keep` keys
    of the prompt sit at slots 0..keep-1 (ring start at 0 = the oldest kept
    position); with `kv_rp` the cache holds the sketched keys (`kv_rp_r`,
    else `kv_rp_matrix`), while the prompt's own attention uses the exact
    ones.  Where the serving step splits the slots over "model"
    (`dist.sharding.kv_seq_shard`), the cache is this rank's block of them
    and holds the kept keys that fall in it."""
    execution.torch_device()
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    x, _ = embed_inputs(params, batch, cfg, cdt)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    rp_r = _kv_rp(cfg, kv_rp_r, x.device)
    _, r, n_kv = shard_rules.kv_seq_shard()
    cache = init_cache(cfg, b, cache_size, x.device, seq_shards=n_kv)
    n = min(s, cache["k"].shape[2] * n_kv)
    lo, cnt = prompt_slots(n, cache["k"].shape[2], r)
    for i in range(cfg.n_layers):
        lp = blocks.cast(_gathered(blocks.layer_params(params, i), cfg), cdt)
        x, _, (k, vv) = _layer(lp, x, cfg, positions, execution.backend)
        if cnt:
            cache["k"][i, :, :cnt] = _sketch_k(k[:, s - n + lo:s - n + lo + cnt], rp_r)
            cache["v"][i, :, :cnt] = vv[:, s - n + lo:s - n + lo + cnt]
    x = blocks.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (x @ _head(params, cfg).to(cdt)).to(torch.float32)
    cache["len"] = torch.tensor(n, dtype=torch.int32)
    cache["pos"] = torch.tensor(s, dtype=torch.int32)
    return logits[:, 0], cache


def decode_step(params: Params, token: torch.Tensor, cache: Dict[str, torch.Tensor],
                cfg: ArchConfig, *, execution: Execution = Execution(),
                kv_rp_r: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token: token (B,) int -> (logits (B, V) f32, updated cache).

    The new key and value are written into the given cache's `k` / `v`
    tensors in place (the reference donates the cache to the same effect);
    the returned dict holds those tensors and the advanced `len` / `pos`.
    The slot is `len` while the cache fills, then `pos % S` (the
    reference's ring).  With `kv_rp`, q and the new key are sketched by the
    same R as `prefill`'s, and the scores keep the 1/sqrt(dh) scale.  A
    cache split over "model" is this rank's block of the slots: the rank
    that owns the slot writes it, and attention merges every rank's own
    slots (`blocks.decode_attention`)."""
    execution.torch_device()
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    x = blocks.embed(params, token[:, None], cdt)                      # (B, 1, d)
    b = x.shape[0]
    k_c, v_c = cache["k"], cache["v"]
    shard = shard_rules.kv_seq_shard()
    s_loc = k_c.shape[2]
    s_max = s_loc * shard[2]
    pos, n = int(cache["pos"]), int(cache["len"])
    slot = n if n < s_max else pos % s_max
    owner, j = divmod(slot, s_loc)
    new_len = min(n + 1, s_max)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    rp_r = _kv_rp(cfg, kv_rp_r, x.device)
    for i in range(cfg.n_layers):
        lp = blocks.cast(_gathered(blocks.layer_params(params, i), cfg), cdt)
        h = blocks.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, vv = _attn_proj(lp, h, cfg, positions)
        q, k = _sketch_k(q, rp_r), _sketch_k(k, rp_r)
        if owner == shard[1]:
            k_c[i, :, j] = k[:, 0].to(k_c.dtype)
            v_c[i, :, j] = vv[:, 0].to(v_c.dtype)
        attn = blocks.decode_attention(q, k_c[i], v_c[i], new_len, window=cfg.sliding_window,
                                       scale_dh=cfg.dh, seq_shard=shard)
        x = x + attn.reshape(b, 1, -1) @ lp["wo"]
        y, _ = _ffn(lp, blocks.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
        x = x + y
    x = blocks.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ _head(params, cfg).to(cdt)).to(torch.float32)
    new_cache = {"k": k_c, "v": v_c,
                 "len": torch.tensor(new_len, dtype=torch.int32),
                 "pos": torch.tensor(pos + 1, dtype=torch.int32)}
    return logits, new_cache
