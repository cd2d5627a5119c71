"""RWKV-6 "Finch": an attention-free LM with data-dependent per-channel decay.

The port of the JAX package's `models/rwkv6.py`: `init_params`,
`init_state`, `loss_fn` over `hidden_states` (each layer under checkpoint
with `remat`), `forward`, and the serving steps `prefill` / `decode_step`.  Per layer a time-mix block (the WKV6 recurrence over a per-head
(Dh × Dh) state) and a channel-mix block; heads are d_model / 64.  The
decode state is O(1) in the sequence length: the WKV matrices, the two
token-shift inputs of each layer and the position, no KV cache.

Parameters are a plain dict with the reference's keys and its stacked
`[L, ...]` layout (`bridge.params_from_reference` maps the JAX pytree leaf
by leaf); the layer stack is a Python loop in place of `lax.scan`.  On a
mesh each layer computes on the rank's shards: gathered whole with one
`model` rank or where the ranks do not divide the heads
(`blocks.gather_layer`), else split over `model` as the reference pins it
(`_tp`): the stream whole, the time mix by WKV head (`ln_x` across the
ranks, `wo` row-parallel), the channel mix by d_ff (`_channel_mix`), the
ranks repeating one loss; decode on the stored columns.  The WKV
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
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.execution import Execution
from repro_torch.dist import sharding as shard_rules
from repro_torch.models import blocks, transformer
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


class _TP(NamedTuple):
    """How a meshed step's layers split over "model" (`_tp`)."""
    mesh: Any
    r: int          # this rank's index along "model"
    n: int          # "model" ranks
    cm: bool        # the channel mix's d_ff splits


def _tp(params: Params, cfg: ArchConfig) -> Optional[_TP]:
    """The split of a meshed step's layers over "model", read from their
    shards: None without a mesh, with one `model` rank or where the ranks
    do not divide the WKV heads (every path is then the single-rank code)."""
    split = shard_rules.model_split_of(params["layers"]["wr"])
    if split is None or (cfg.d_model // HEAD_DIM) % split[2]:
        return None
    mesh, r, n, _ = split
    return _TP(mesh, r, n, cfg.d_ff % n == 0)


class _Reads(NamedTuple):
    """How a block reads its leaves `lp`: "plain" tensors, or a rank's
    `LayerShard`s — "whole" (every rank computes the block whole),
    "split" (this rank's WKV heads or d_ff columns; the block's input is
    then read through `SumGrad`, so each rank's gradient of a leaf it
    reads whole is a share, summed over "model") or "stored" (decode:
    every product on the rank's stored columns, `transformer._all_cols`)."""
    lp: Params
    tp: Optional[_TP] = None
    mode: str = "plain"

    def vec(self, name: str) -> torch.Tensor:
        """A leaf read whole."""
        t = self.lp[name]
        return t.whole(model_sum=True) if self.mode == "split" else shard_rules.read_whole(t)

    def own(self, name: str) -> torch.Tensor:
        """A leaf by its last dim's channels: where split, this rank's
        stored block (the ranks divide d and d_ff, so "model" splits every
        leaf's last dim), else whole."""
        return self.lp[name].block() if self.mode == "split" else self.vec(name)

    def mm(self, h: torch.Tensor, name: str, part: str = "cols") -> torch.Tensor:
        """h @ the leaf: where split, this rank's block of its columns
        (`part` "cols") or of its rows ("rows": a partial sum), or every
        column ("all"); decode's stored columns, gathered."""
        if self.mode == "stored":
            return transformer._all_cols(self.lp[name], h, self.tp)
        if self.mode == "split" and part == "rows":
            return h @ self.lp[name].rows()
        return h @ (self.own(name) if part == "cols" else self.vec(name))


def _time_mix(lp, x, prev_x, state, cfg: ArchConfig, nh: int, rd: Optional[_Reads] = None):
    """x: the layer's normed input (B, S, d) -> (out, x[:, -1], new wkv
    state).  `rd` "split": this rank's WKV heads nh / n — r, k, v, g and the
    decay from its head columns (the decay's `w_lora_a` whole), `u_bonus`
    by its rows, `ln_x` across the ranks (`blocks.rms_norm_split`), `wo`
    row-parallel, met in an all-reduce (`ReduceModel`); the state is its
    heads'."""
    rd = rd or _Reads(lp)
    b, s, d = x.shape
    split = rd.mode == "split"
    if split:
        x = shard_rules.SumGrad.apply(x, rd.tp.mesh, "model")
        nh //= rd.tp.n
    xp = _token_shift(x, prev_x)

    def mix(name):
        m = rd.vec(name).to(x.dtype)
        return x * m + xp * (1.0 - m)

    r = rd.mm(mix("mix_r"), "wr").reshape(b, s, nh, HEAD_DIM)
    k = rd.mm(mix("mix_k"), "wk").reshape(b, s, nh, HEAD_DIM)
    v = rd.mm(mix("mix_v"), "wv").reshape(b, s, nh, HEAD_DIM)
    g = blocks.act_fn("silu")(rd.mm(mix("mix_g"), "wg"))
    # data-dependent decay, summed in w_base's dtype (the compute dtype)
    w_log = rd.own("w_base") + rd.mm(torch.tanh(rd.mm(mix("mix_w"), "w_lora_a", "all")),
                                     "w_lora_b")
    w = torch.exp(-torch.exp(w_log.to(torch.float32))).to(x.dtype)
    w = w.reshape(b, s, nh, HEAD_DIM)
    u = rd.lp["u_bonus"].rows() if split else rd.vec("u_bonus")
    out, state = _wkv_scan(r, k, v, w.to(torch.float32), u.to(torch.float32), state)
    out = out.reshape(b, s, nh * HEAD_DIM).to(x.dtype)
    if split:
        out = blocks.rms_norm_split(out, rd.own("ln_x"), cfg.norm_eps, rd.tp.mesh) * g
        return (shard_rules.ReduceModel.apply(rd.mm(out, "wo", "rows"), rd.tp.mesh), x[:, -1],
                state)
    out = blocks.rms_norm(out, rd.vec("ln_x"), cfg.norm_eps) * g
    return rd.mm(out, "wo", "all"), x[:, -1], state


def _channel_mix(lp, x, prev_x, rd: Optional[_Reads] = None):
    """`rd` "split": `cm_k` column-parallel over d_ff and `cm_v`
    row-parallel, whose partial sums reduce-scatter along d to meet this
    rank's columns of `cm_r`; their product gathered along d (the ranks
    repeat the loss: `GatherRepl`), so no rank reads `cm_r` whole."""
    rd = rd or _Reads(lp)
    split = rd.mode == "split"
    if split:
        x = shard_rules.SumGrad.apply(x, rd.tp.mesh, "model")
    xp = _token_shift(x, prev_x)
    cr = rd.vec("cmix_r").to(x.dtype)
    ck = rd.vec("cmix_k").to(x.dtype)
    r = blocks.sigmoid(rd.mm(x * cr + xp * (1 - cr), "cm_r"))
    k = rd.mm(x * ck + xp * (1 - ck), "cm_k")
    kv = rd.mm(torch.square(F.relu(k)), "cm_v", "rows")
    if split:
        mesh = rd.tp.mesh
        kv = shard_rules.ScatterSeq.apply(kv, mesh, 2)
        return shard_rules.GatherRepl.apply(r * kv, mesh, "model", 2), x[:, -1]
    return r * kv, x[:, -1]


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


def _block(lp, x, cfg: ArchConfig, nh: int, wkv0, sh_t0, sh_c0, tp: Optional[_TP] = None,
           stored: bool = False):
    """One layer from its states -> (x, wkv, shift_t, shift_c).  With `tp`
    (`lp` the layer's `LayerShard`s) the stream stays whole: this rank's
    WKV heads and d_ff columns (the channel mix whole where the ranks do
    not divide d_ff), the state its heads'; with `stored` (decode) every
    head on the stored columns against the whole state."""
    if tp is None:
        tm = cm = _Reads(lp)
    elif stored:
        tm = cm = _Reads(lp, tp, "stored")
    else:
        tm, cm = _Reads(lp, tp, "split"), _Reads(lp, tp, "split" if tp.cm else "whole")
    h = blocks.rms_norm(x, shard_rules.read_whole(lp["ln1"]), cfg.norm_eps)
    dt, sh_t, wkv = _time_mix(lp, h, sh_t0.to(x.dtype), wkv0, cfg, nh, tm)
    x = x + dt
    h = blocks.rms_norm(x, shard_rules.read_whole(lp["ln2"]), cfg.norm_eps)
    dc, sh_c = _channel_mix(lp, h, sh_c0.to(x.dtype), cm)
    return x + dc, wkv, sh_t, sh_c


def hidden_states(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
                  remat: bool = True, execution: Execution = Execution(),
                  state: Dict[str, torch.Tensor] = None, want_state: bool = True):
    """Backbone pass -> (final normed hidden (B, S, d), aux {}, new state).

    A given `state`'s tensors are overwritten with the new state (the
    serving steps).  Without one the layers start from zero states and the
    new state is built from their outputs, nothing written in place, so
    autograd can run through it (the training forward: with `remat` each
    layer under checkpoint, its leaves cast inside the checkpointed
    body); `want_state` False (the loss) builds none.

    Where the layers split over "model" (`_tp`) the stream is whole on
    every rank, as the reference pins it, and the ranks repeat one loss:
    from zero states (train, prefill) each rank computes its WKV heads and
    d_ff columns (`_block`), the new state's heads gathered over "model";
    from a given state (decode) every head on the stored columns against
    the replicated state, so no state moves between ranks."""
    dev = execution.torch_device()
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    x = transformer._embed_rows(params, batch["tokens"], cdt)
    b = x.shape[0]
    nh = cfg.d_model // HEAD_DIM
    tp = _tp(params, cfg)
    fresh = state is None
    zeros = init_state(cfg, b, dev) if fresh else None
    pos = 0 if fresh else int(state["pos"])
    # from zero states a split layer starts from its heads' block of them
    heads = None if tp is None or not fresh else slice(tp.r * nh // tp.n, (tp.r + 1) * nh // tp.n)

    def body(x, lp, wkv0, sh_t0, sh_c0):
        lp = blocks.cast_stacked(lp if tp is not None else blocks.gather_layer(lp), cdt)
        return _block(lp, x, cfg, nh, wkv0, sh_t0, sh_c0, tp, stored=not fresh)

    outs = []
    for i, lp in enumerate(blocks.unstacked(params)):
        src = zeros if fresh else state
        wkv0 = src["wkv"][i] if heads is None else src["wkv"][i][:, heads]
        args = (x, lp, wkv0, src["shift_t"][i], src["shift_c"][i])
        x, wkv, sh_t, sh_c = blocks.remat(body, *args) if remat else body(*args)
        if fresh:
            outs.append((wkv, sh_t, sh_c))
        else:
            state["wkv"][i] = wkv
            state["shift_t"][i] = sh_t
            state["shift_c"][i] = sh_c
    x = blocks.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if fresh and not want_state:
        return x, {}, None
    if fresh:
        state = {name: torch.stack(ts) for name, ts in
                 zip(("wkv", "shift_t", "shift_c"), zip(*outs))}
        if tp is not None:
            state["wkv"] = shard_rules.all_gather_cat(state["wkv"], tp.mesh, "model", 2)
    new_state = {"wkv": state["wkv"], "shift_t": state["shift_t"], "shift_c": state["shift_c"],
                 "pos": torch.tensor(pos + x.shape[1], dtype=torch.int32)}
    return x, {}, new_state


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            remat: bool = True, execution: Execution = Execution()):
    """(mean next-token NLL, {"ce": it}) from zero states."""
    x, _, _ = hidden_states(params, batch, cfg, remat=remat, execution=execution,
                            want_state=False)
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
    return transformer._logits(params, x[:, -1], cfg, x.dtype), state


def decode_step(params: Params, token: torch.Tensor, state: Dict[str, torch.Tensor],
                cfg: ArchConfig, *, execution: Execution = Execution()):
    """One token through the recurrence: token (B,) int -> (logits (B, V)
    f32, new state).  The given state's `wkv`, `shift_t` and `shift_c`
    tensors are overwritten in place (the reference donates the state to
    the same effect); the returned dict holds them and the advanced `pos`."""
    x, _, state = hidden_states(params, {"tokens": token[:, None]}, cfg,
                                execution=execution, state=state)
    return transformer._logits(params, x[:, 0], cfg, x.dtype), state
