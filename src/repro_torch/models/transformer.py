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
RP-compressed KV cache (`kv_rp`).

On a mesh the layers compute on the rank's shards (`dist.sharding.
LayerShard`).  With one `model` rank each layer body gathers its leaves
whole (`blocks.gather_layer`; the MoE expert stacks are gathered by
`blocks.moe_layer`).  With several, the layer splits over `model` in the
layouts the reference pins (`_tp`; its layer body's `constrain(x,
"batch", "model", None)` and its rules' tensor parallelism over the
leaves' last dim): between layers and through the norms the residual
stream is this rank's sequence block (B_local, S/n, d), which is also
what `remat` keeps; each layer gathers the normed stream along S before
its column-parallel products (`wq`, `wk`, `wv`, `w_in`, `w_gate`: this
rank's columns, gathered over the DP axes only) and reduce-scatters it
after the row-parallel ones (`wo`, `w_out`: this rank's rows, moved from
the stored column split by one all-to-all); attention (B4 with the kernel
backend) runs on this rank's query heads and the K/V heads they read
(`LayerShard.cols` exchanges the columns of a K/V head that straddles two
ranks' blocks); a MoE layer dispatches the token-split stream directly.
The final norm, the head and the loss run on the rank's sequence block,
and each rank's loss is its share (`loss_fn`).  The reference's degrade
rule: a stream length `model` does not divide stays whole (its products
still split, meeting in an all-reduce), query heads it does not divide
split the query rows instead (each rank's block of queries over the
gathered K/V, B4's `q_offset`), and a `d_ff` it does not divide runs on
the rank's rows whole.  Decode keeps the stream whole (one token): each
rank computes its stored columns of every product (q / k / v, `wo`, the
MLP), and the (B, 1, ·) outputs are gathered over `model`, so no weight
leaves its rank's `model` block (a row-parallel `wo` would reshard it by
an all-to-all every step).  The serving
steps keep the K/V cache's slots split over "model"
(`dist.sharding.kv_seq_shard`): prefill sends each rank its slot range of
every K/V head (one all-to-all a layer), decode writes the new key on the
rank that owns its slot and attends over the rank's own slots
(`blocks.decode_attention`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

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
# the layer split over "model" (tensor and sequence parallelism)
# ---------------------------------------------------------------------------

class _TP(NamedTuple):
    """How a meshed step's layers split over "model" (`_tp`)."""
    mesh: Any
    r: int          # this rank's index along "model"
    n: int          # "model" ranks
    seq: bool       # the stream is split by sequence (train / prefill; n divides S)
    heads: bool     # the query heads split: rank r computes heads r·hq/n ..
    ffn: bool       # the dense MLP's d_ff splits


def _tp(params: Params, cfg: ArchConfig) -> Optional[_TP]:
    """The split of a meshed step's layers over "model", read from their
    shards: None without a mesh or with one `model` rank (every path is then
    the single-rank code)."""
    split = shard_rules.model_split_of(params["layers"]["wq"])
    if split is None:
        return None
    mesh, r, n, seq = split
    return _TP(mesh, r, n, seq, splits_heads(cfg, n), cfg.moe is None and cfg.d_ff % n == 0)


def splits_heads(cfg: ArchConfig, n: int) -> bool:
    """Whether attention's query heads split over n ranks of "model": n
    divides them and each rank's heads read their K/V heads in the
    attention's GQA order (whole K/V groups, or part of one)."""
    qn, g = cfg.n_heads // n, cfg.n_heads // cfg.n_kv_heads
    return cfg.n_heads % n == 0 and (qn % g == 0 or g % qn == 0)


def _head_ranges(cfg: ArchConfig, n: int) -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """Per rank of "model": (its query heads, the K/V heads they read), as
    [lo, hi) ranges; n divides the query heads."""
    qn, g = cfg.n_heads // n, cfg.n_heads // cfg.n_kv_heads
    return [((j * qn, (j + 1) * qn), (j * qn // g, ((j + 1) * qn - 1) // g + 1)) for j in range(n)]


def _enter(h: torch.Tensor, tp: _TP) -> torch.Tensor:
    """The normed stream a column-parallel product reads: every position,
    gathered along S where the stream is split (`GatherRows`), else the
    whole stream every rank holds (`SumGrad`: its gradient is each rank's
    share)."""
    if tp.seq:
        return shard_rules.GatherRows.apply(h, tp.mesh, "model", 1)
    return shard_rules.SumGrad.apply(h, tp.mesh, "model")


def _leave(o: torch.Tensor, tp: _TP) -> torch.Tensor:
    """A row-parallel product's partial sums back to the stream's layout:
    reduce-scattered along S (`ScatterSeq`), or all-reduced (`ReduceModel`)."""
    if tp.seq:
        return shard_rules.ScatterSeq.apply(o, tp.mesh, 1)
    return shard_rules.ReduceModel.apply(o, tp.mesh)


def _attention_tp(lp: Params, h: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                  backend: str, tp: _TP, lo: int):
    """Attention on the normed stream h (this rank's block from position
    `lo`, or the whole) -> (its output in h's layout, (k, v, first K/V
    head held)).  Heads split: this rank's query heads and the K/V heads
    they read over every position.  Else, with the stream split: this
    rank's query rows over the K/V of every position, gathered along S.
    Else every head on every rank (the degrade rule)."""
    b, s_loc, _ = h.shape
    dh = cfg.dh
    if tp.heads:
        hf = _enter(h, tp)
        s = hf.shape[1]
        ranges = _head_ranges(cfg, tp.n)
        qh, kh = ranges[tp.r]
        wq = lp["wq"].cols([(a * dh, c * dh) for (a, c), _ in ranges])
        kv_cols = [(a * dh, c * dh) for _, (a, c) in ranges]
        q = (hf @ wq).reshape(b, s, qh[1] - qh[0], dh)
        k = (hf @ lp["wk"].cols(kv_cols)).reshape(b, s, kh[1] - kh[0], dh)
        vv = (hf @ lp["wv"].cols(kv_cols)).reshape(b, s, kh[1] - kh[0], dh)
        if cfg.causal:
            q = blocks.apply_rope(q, positions, cfg.rope_theta)
            k = blocks.apply_rope(k, positions, cfg.rope_theta)
        attn = blocks.flash_attention(q, k, vv, causal=cfg.causal, window=cfg.sliding_window,
                                      q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                                      backend=backend)
        out = _leave(attn.reshape(b, s, -1) @ lp["wo"].rows(), tp)
        return out, (k, vv, kh[0])
    p = {name: lp[name].whole() for name in ("wq", "wk", "wv", "wo")}
    if tp.seq:
        q, k, vv = _attn_proj(p, h, cfg, positions[:, lo:lo + s_loc])
        k = shard_rules.GatherRows.apply(k, tp.mesh, "model", 1)
        vv = shard_rules.GatherRows.apply(vv, tp.mesh, "model", 1)
        attn = blocks.flash_attention(q, k, vv, causal=cfg.causal, window=cfg.sliding_window,
                                      q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk, q_offset=lo,
                                      backend=backend)
    else:
        q, k, vv = _attn_proj(p, h, cfg, positions)
        attn = blocks.flash_attention(q, k, vv, causal=cfg.causal, window=cfg.sliding_window,
                                      q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                                      backend=backend)
    return attn.reshape(b, s_loc, -1) @ p["wo"], (k, vv, 0)


def _ffn_tp(lp: Params, h: torch.Tensor, cfg: ArchConfig, tp: _TP):
    """The MLP or MoE on normed h in the stream's layout -> (y, aux): the
    dense MLP column / row parallel where `model` divides d_ff, else on
    the rank's rows whole; a MoE layer through `blocks.moe_layer`, which
    dispatches a split stream's tokens directly."""
    if cfg.moe is not None:
        p = {"router": lp["router"].whole(), **{k: lp[k] for k in blocks.EXPERT_KEYS}}
        return blocks.moe_layer(p, h, cfg.moe, cfg.act)
    names = [k for k in ("w_in", "w_gate") if k in lp]
    if tp.ffn:
        f = cfg.d_ff // tp.n
        w = {k: lp[k].cols([(j * f, (j + 1) * f) for j in range(tp.n)]) for k in names}
        w["w_out"] = lp["w_out"].rows()
        y = _leave(blocks.mlp(w, _enter(h, tp), cfg.act), tp)
    else:
        y = blocks.mlp({k: lp[k].whole() for k in names + ["w_out"]}, h, cfg.act)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    return y, {"moe_lb": zero, "moe_z": zero}


def _layer_tp(lp: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
              backend: str, tp: _TP, lo: int):
    """One block split over "model" -> (x, aux, (k, v, first K/V head));
    x is this rank's sequence block from position `lo` where the stream
    splits, else the whole stream."""
    h = blocks.rms_norm(x, lp["ln1"].whole(), cfg.norm_eps)
    a, kv = _attention_tp(lp, h, cfg, positions, backend, tp, lo)
    x = x + a
    y, aux = _ffn_tp(lp, blocks.rms_norm(x, lp["ln2"].whole(), cfg.norm_eps), cfg, tp)
    return x + y, aux, kv


# ---------------------------------------------------------------------------
# embedding / front-end
# ---------------------------------------------------------------------------

def _project(params: Params, feats: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    w = shard_rules.read_whole(params["frontend_proj"])
    return feats.to(device=w.device, dtype=compute_dtype) @ w.to(compute_dtype)


def embed_inputs(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
                 compute_dtype: torch.dtype) -> Tuple[torch.Tensor, int]:
    """Returns (x (B, S_total, d), n_prefix), where the n_prefix leading
    positions carry modality front-end content: audio frames (B, S, f) run
    through `frontend_proj` in place of the tokens; vision patches (B, P, f)
    are projected and put before the tokens' embeddings."""
    if cfg.frontend == "audio":
        return _project(params, batch["frames"], compute_dtype), 0
    x = blocks.embed(params, batch["tokens"], compute_dtype)
    if cfg.frontend == "vision":
        px = _project(params, batch["patches"], compute_dtype)
        return torch.cat([px, x], dim=1), px.shape[1]
    return x, 0


def stream_len(cfg: ArchConfig, batch: Dict[str, Any]) -> int:
    """S_total: the positions `embed_inputs` makes of a batch."""
    if cfg.frontend == "audio":
        return int(batch["frames"].shape[1])
    s = int(batch["tokens"].shape[1])
    return s + int(batch["patches"].shape[1]) if cfg.frontend == "vision" else s


def embed_block(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
                compute_dtype: torch.dtype, lo: int, hi: int) -> Tuple[torch.Tensor, int]:
    """Positions [lo, hi) of `embed_inputs`' stream, embedding or projecting
    only those, and n_prefix.  A vision block reads both the projection and
    the embedding, one of them perhaps on no rows, so that every rank's
    backward reaches both leaves' gradient sums."""
    if cfg.frontend == "audio":
        return _project(params, batch["frames"][:, lo:hi], compute_dtype), 0
    tokens = batch["tokens"]
    if cfg.frontend != "vision":
        return blocks.embed(params, tokens[:, lo:hi], compute_dtype), 0
    p = int(batch["patches"].shape[1])
    px = _project(params, batch["patches"][:, min(lo, p):min(hi, p)], compute_dtype)
    tx = blocks.embed(params, tokens[:, max(lo, p) - p:max(hi, p) - p], compute_dtype)
    return torch.cat([px, tx], dim=1), p


def _embed_stream(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
                  compute_dtype: torch.dtype, tp) -> Tuple[torch.Tensor, int, int]:
    """(x, n_prefix, lo): the stream's positions from `lo` that this rank
    holds — its sequence block where the layers split the stream over
    "model" (`_tp`), else every position from 0."""
    if tp is None or not tp.seq:
        return (*embed_inputs(params, batch, cfg, compute_dtype), 0)
    blk = stream_len(cfg, batch) // tp.n
    return (*embed_block(params, batch, cfg, compute_dtype, tp.r * blk, (tp.r + 1) * blk),
            tp.r * blk)


def _stream_targets(tokens: torch.Tensor, n_prefix: int, s_total: int,
                    causal: bool) -> torch.Tensor:
    """The loss's target at every stream position, −1 where none: the next
    token past the modality prefix for a causal LM, the token at each
    position for the encoder (what `loss_fn` pairs without a split)."""
    b, t = tokens.shape
    out = torch.full((b, s_total), -1, dtype=torch.long, device=tokens.device)
    if causal:
        out[:, n_prefix:n_prefix + t - 1] = tokens[:, 1:]
    else:
        out[:, :t] = tokens
    return out


def _head(params: Params, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return shard_rules.read_whole(params["embed"]).T
    return shard_rules.read_whole(params["lm_head"])


# Serving on a split reads the embedding and the head in their stored
# `model` block (the serving steps hand the leaves outside the layers out on
# their shards, `compute_params(lazy=True)`): one token's rows of the
# table's columns, and the head's columns of the vocabulary, each gathered
# over "model" as a (B, ·) activation.  The recurrent families' serving
# reads them here too.

def _embed_rows(params: Params, tokens: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """`blocks.embed`, from the table's stored `model` block where it is
    one (the rows' column blocks gathered over "model")."""
    t = params["embed"]
    if not isinstance(t, shard_rules.LayerShard):
        return blocks.embed(params, tokens, cdt)
    x = t.block()[tokens.to(device=t.local.device, dtype=torch.long)].to(cdt)
    return shard_rules.all_gather_cat(x, t.mesh, "model", x.ndim - 1) if t.model_split else x


def _logits(params: Params, x: torch.Tensor, cfg: ArchConfig, cdt: torch.dtype) -> torch.Tensor:
    """f32 logits of x (B, d): the head's stored columns of the vocabulary
    where it is one, gathered over "model"."""
    head = params["lm_head"] if not cfg.tie_embeddings else None
    if not isinstance(head, shard_rules.LayerShard):
        return (x @ _head(params, cfg).to(cdt)).to(torch.float32)
    y = (x @ head.block().to(cdt)).to(torch.float32)
    return shard_rules.all_gather_cat(y, head.mesh, "model", y.ndim - 1) if head.model_split else y


# ---------------------------------------------------------------------------
# training forward + loss
# ---------------------------------------------------------------------------

def hidden_states(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
                  remat: bool = True, execution: Execution = Execution()
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence backbone -> (final normed hidden (B, S_total, d), aux):
    aux holds `moe_lb` / `moe_z` averaged over the layers, `n_prefix`, and
    `split`: None, or on a stream split over "model" (`_tp`) the split and
    the first position of this rank's block, which is then what the hidden
    states hold (B, S_total / n, d).

    With `remat` and grad enabled each layer runs under checkpoint, its
    leaves cast to the compute dtype inside the checkpointed body (so the
    compute-dtype copies are remade in the backward, never stored), by the
    reference's rule for the stacked leaves (`blocks.cast_stacked`)."""
    execution.torch_device()
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    tp = _tp(params, cfg)
    x, n_prefix, lo = _embed_stream(params, batch, cfg, cdt, tp)
    positions = torch.arange(stream_len(cfg, batch), device=x.device)[None, :]

    def body(x, lp):
        if tp is None:
            x, aux, _ = _layer(blocks.cast_stacked(_gathered(lp, cfg), cdt), x, cfg, positions,
                               execution.backend)
        else:
            x, aux, _ = _layer_tp(blocks.cast_stacked(lp, cdt), x, cfg, positions,
                                  execution.backend, tp, lo)
        return x, aux["moe_lb"], aux["moe_z"]

    lb = lz = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in blocks.unstacked(params):
        x, lb_i, lz_i = blocks.remat(body, x, lp) if remat else body(x, lp)
        lb, lz = lb + lb_i, lz + lz_i
    x = blocks.rms_norm(x, params["final_norm"], cfg.norm_eps)
    split = (tp, lo) if tp is not None and tp.seq else None
    return x, {"moe_lb": lb / cfg.n_layers, "moe_z": lz / cfg.n_layers, "n_prefix": n_prefix,
               "split": split}


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            remat: bool = True, execution: Execution = Execution()
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, aux): the mean token NLL over the text region (next-token
    targets past the modality prefix for a causal LM; the token at each
    position for the encoder), plus 0.01·moe_lb + moe_z; aux holds `ce`,
    `moe_lb` and `moe_z`.

    On a stream split over "model" each rank runs the head and the NLL on
    its sequence block, and `total` is this rank's share of the loss: its
    NLL sum over the count of every rank's targets, plus the aux terms
    over the rank count (the ranks' shares sum to the loss; `ce` in aux is
    the whole)."""
    x, aux = hidden_states(params, batch, cfg, remat=remat, execution=execution)
    n_prefix = aux["n_prefix"]
    tokens = batch["tokens"].to(x.device)
    if aux["split"] is not None:
        tp, lo = aux["split"]
        targets = _stream_targets(tokens, n_prefix, stream_len(cfg, batch), cfg.causal)
        nll, count = blocks.chunked_xent_sums(x, _head(params, cfg),
                                              targets[:, lo:lo + x.shape[1]])
        count = shard_rules.all_reduce_sum_(count.detach().clone(), tp.mesh, "model")
        loss = nll / torch.clamp(count, min=1.0)
        total = loss + (0.01 * aux["moe_lb"] + aux["moe_z"]) / tp.n
        ce = shard_rules.all_reduce_sum_(loss.detach().clone(), tp.mesh, "model")
        return total, {"ce": ce, "moe_lb": aux["moe_lb"], "moe_z": aux["moe_z"]}
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


def _kv_slots(k: torch.Tensor, k0: int, tp: _TP, cfg: ArchConfig, s: int, n: int, slots: int,
              n_kv: int, rp_r: Optional[torch.Tensor]) -> torch.Tensor:
    """Every K/V head of the kept prompt keys in this rank's slot range,
    from `k` (B, S, heads, dh) holding K/V heads k0.. of every position:
    rank j sends rank t the heads it is the first to hold, at t's slots
    (one all-to-all over "model"; `dist.sharding.exchange`), sketched by
    `rp_r` on the way."""
    firsts, top = [], 0
    for _, (a, c) in _head_ranges(cfg, tp.n):
        a = max(a, top)
        firsts.append((a, max(a, c)))
        top = max(top, c)

    def slot_range(t):
        lo, cnt = prompt_slots(n, slots, t if n_kv > 1 else 0)
        return s - n + lo, cnt

    a, c = firsts[tp.r]
    send = []
    for t in range(tp.n):
        p0, cnt = slot_range(t)
        send.append(_sketch_k(k[:, p0:p0 + cnt, a - k0:c - k0], rp_r).contiguous())
    cnt = slot_range(tp.r)[1]
    shapes = [(k.shape[0], cnt, c_ - a_, send[0].shape[-1]) for a_, c_ in firsts]
    parts = shard_rules.exchange(send, shapes, tp.mesh, "model")
    return torch.cat(parts, dim=2)


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
    and holds the kept keys that fall in it; where the layers split over
    "model" (`_tp`) and a rank holds only some K/V heads, each rank gets
    every head of its slots from the ranks that hold them (`_kv_slots`)."""
    execution.torch_device()
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    tp = _tp(params, cfg)
    x, _, lo = _embed_stream(params, batch, cfg, cdt, tp)
    b, s = x.shape[0], stream_len(cfg, batch)
    positions = torch.arange(s, device=x.device)[None, :]
    rp_r = _kv_rp(cfg, kv_rp_r, x.device)
    _, r, n_kv = shard_rules.kv_seq_shard()
    cache = init_cache(cfg, b, cache_size, x.device, seq_shards=n_kv)
    slots = cache["k"].shape[2]
    n = min(s, slots * n_kv)
    lo_slot, cnt = prompt_slots(n, slots, r)
    # whether some rank holds only some K/V heads (the same answer on every rank)
    some_heads = tp is not None and tp.heads and any(
        c - a < cfg.n_kv_heads for _, (a, c) in _head_ranges(cfg, tp.n))
    for i in range(cfg.n_layers):
        if tp is None:
            lp = blocks.cast(_gathered(blocks.layer_params(params, i), cfg), cdt)
            x, _, (k, vv) = _layer(lp, x, cfg, positions, execution.backend)
            k0 = 0
        else:
            lp = blocks.cast(blocks.layer_params(params, i), cdt)
            x, _, (k, vv, k0) = _layer_tp(lp, x, cfg, positions, execution.backend, tp, lo)
        if some_heads:
            cache["k"][i, :, :cnt] = _kv_slots(k, k0, tp, cfg, s, n, slots, n_kv, rp_r)
            cache["v"][i, :, :cnt] = _kv_slots(vv, k0, tp, cfg, s, n, slots, n_kv, None)
        elif cnt:
            cache["k"][i, :, :cnt] = _sketch_k(k[:, s - n + lo_slot:s - n + lo_slot + cnt], rp_r)
            cache["v"][i, :, :cnt] = vv[:, s - n + lo_slot:s - n + lo_slot + cnt]
    last = x[:, -1:]
    if tp is not None and tp.seq:            # the last position is the last rank's
        last = shard_rules.all_gather_cat(last, tp.mesh, "model", 1)[:, -1:]
    x = blocks.rms_norm(last, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x, cfg, cdt)
    cache["len"] = torch.tensor(n, dtype=torch.int32)
    cache["pos"] = torch.tensor(s, dtype=torch.int32)
    return logits[:, 0], cache


def _all_cols(w: shard_rules.LayerShard, h: torch.Tensor, tp: _TP) -> torch.Tensor:
    """h @ the whole leaf on a stream every rank holds whole (decode): each
    rank multiplies by its stored columns, gathered over the DP axes only,
    and the (B, 1, ·) products are gathered over "model" (serving only: no
    gradient); a leaf "model" does not split is read whole."""
    y = h @ w.block()
    return shard_rules.all_gather_cat(y, tp.mesh, "model", y.ndim - 1) if w.model_split else y


def _decode_ffn(lp: Params, h: torch.Tensor, cfg: ArchConfig, tp: _TP) -> torch.Tensor:
    """The dense MLP on decode's whole stream, every product on the stored
    columns (`_all_cols`); a MoE layer through `blocks.moe_layer`."""
    if cfg.moe is not None:
        return _ffn_tp(lp, h, cfg, tp)[0]
    a = _all_cols(lp["w_in"], h, tp)
    if "w_gate" in lp:
        a = blocks.act_fn(cfg.act)(_all_cols(lp["w_gate"], h, tp)) * a
    else:
        a = blocks.act_fn(cfg.act)(a)
    return _all_cols(lp["w_out"], a, tp)


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
    slots (`blocks.decode_attention`).  Where the layers split over "model"
    (`_tp`) the stream stays whole and every dense product runs on each
    rank's stored columns, the (B, 1, ·) outputs gathered over "model"
    (`_all_cols`): the weights never leave their rank's `model` block."""
    execution.torch_device()
    cdt = blocks.torch_dtype(cfg.compute_dtype)
    tp = _tp(params, cfg)
    x = _embed_rows(params, token[:, None], cdt)                       # (B, 1, d)
    b = x.shape[0]
    dh, hq, hkv = cfg.dh, cfg.n_heads, cfg.n_kv_heads
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
        if tp is None:
            lp = blocks.cast(_gathered(blocks.layer_params(params, i), cfg), cdt)
            h = blocks.rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k, vv = _attn_proj(lp, h, cfg, positions)
        else:
            lp = blocks.cast(blocks.layer_params(params, i), cdt)
            h = blocks.rms_norm(x, lp["ln1"].whole(), cfg.norm_eps)
            q = _all_cols(lp["wq"], h, tp).reshape(b, 1, hq, dh)
            k = _all_cols(lp["wk"], h, tp).reshape(b, 1, hkv, dh)
            vv = _all_cols(lp["wv"], h, tp).reshape(b, 1, hkv, dh)
            if cfg.causal:
                q = blocks.apply_rope(q, positions, cfg.rope_theta)
                k = blocks.apply_rope(k, positions, cfg.rope_theta)
        q, k = _sketch_k(q, rp_r), _sketch_k(k, rp_r)
        if owner == shard[1]:
            k_c[i, :, j] = k[:, 0].to(k_c.dtype)
            v_c[i, :, j] = vv[:, 0].to(v_c.dtype)
        attn = blocks.decode_attention(q, k_c[i], v_c[i], new_len, window=cfg.sliding_window,
                                       scale_dh=cfg.dh, seq_shard=shard)
        if tp is None:
            x = x + attn.reshape(b, 1, -1) @ lp["wo"]
            y, _ = _ffn(lp, blocks.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
        else:
            x = x + _all_cols(lp["wo"], attn.reshape(b, 1, -1), tp)
            y = _decode_ffn(lp, blocks.rms_norm(x, lp["ln2"].whole(), cfg.norm_eps), cfg, tp)
        x = x + y
    x = blocks.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x[:, 0], cfg, cdt)
    new_cache = {"k": k_c, "v": v_c,
                 "len": torch.tensor(new_len, dtype=torch.int32),
                 "pos": torch.tensor(pos + 1, dtype=torch.int32)}
    return logits, new_cache
