"""Shared model building blocks: norms, RoPE, attention (forward and
backward, prefill and decode), the chunked cross-entropy, the dense MLP,
the MoE layer and the param helpers (the reference's cast rule, a layer's
slice of the stacked leaves, the token embedding, init).

Plain functions over tensors and parameter dicts, mirroring the JAX
package's `models/blocks.py` and its (B, S, H, Dh) attention layout.
`flash_attention`'s forward goes, with `backend="kernel"`, through the
hand-written CUDA kernel (`kernels.ops.flash_attention`; the plain version
for CPU tensors), otherwise through the plain double-chunked version
(`kernels.ref.flash_attention_ref`).  When an input requires grad it runs
as `FlashAttentionFn`, the port of the reference's custom VJP: the forward
also returns each row's log-sum-exp, and the backward recomputes p from
it.  With `backend="kernel"` and bf16 inputs the backward is the CUDA
kernel (`kernels.ops.flash_attention_bwd`; the plain version for CPU
tensors); otherwise it is `kernels.ref.flash_attention_bwd_ref`, chunk by
chunk in plain PyTorch, as the reference's backward is XLA outside any
Pallas kernel.  `chunked_softmax_xent` is the training loss, one
checkpointed chunk of logits at a time (`chunked_xent_sums` its sum and
count, for a rank's sequence block).  The MoE layer is the reference's
capacity dispatch; given a rank's shards of the expert stacks
(`dist.sharding.LayerShard`, as the meshed steps hand them) it goes
expert-parallel over `model` through two all-to-alls, as the reference's
`shard_map` branch does — on the token-split stream directly where the
stream is split over `model` by sequence — and where expert parallelism
does not apply each rank computes its stored feature columns of every
expert.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from repro_torch.dist import sharding as shard_rules
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, flash_attention_bwd_ref, flash_attention_ref
from repro_torch.models.config import MoESpec


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * w.to(torch.float32)
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in f32, rounded to x's dtype.  Under autograd it keeps only
    its inputs for the backward (a checkpoint, which recomputes the rest):
    the two f32 copies of x it would keep cost more memory than their
    recompute costs time."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return checkpoint(_rms_norm, x, w, eps, use_reentrant=False, preserve_rng_state=False)
    return _rms_norm(x, w, eps)


def rms_norm_split(x: torch.Tensor, w: torch.Tensor, eps: float, mesh) -> torch.Tensor:
    """`rms_norm` of a tensor whose last dim is split over "model" in equal
    blocks, x and w this rank's blocks: the mean of squares spans every
    rank's block (the local sums of squares added over "model"), in f32,
    rounded to x's dtype.  Each rank's output reads the summed squares, so
    their gradients are summed back over "model" too (`SumGrad` under
    `ReduceModel`)."""
    x32 = x.to(torch.float32)
    sq = torch.sum(torch.square(x32), dim=-1, keepdim=True)
    sq = shard_rules.ReduceModel.apply(shard_rules.SumGrad.apply(sq, mesh, "model"), mesh)
    width = x.shape[-1] * shard_rules.axis_size(mesh, "model")
    return (x32 * torch.rsqrt(sq / width + eps) * w.to(torch.float32)).to(x.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.sigmoid's own ops, 1/(1 + e^−x), each rounded to x's dtype as
    # the reference rounds them in bf16 (torch.sigmoid rounds once, which
    # moves about a third of bf16 outputs by one ulp)
    return 1.0 / (1.0 + torch.exp(-x))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """`gelu` is the tanh form, as the reference's; `gelu_erf` the exact
    one (Zamba2's published MLP, a port-only name)."""
    return {"silu": _silu, "gelu": _gelu_tanh, "gelu_erf": F.gelu, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(dh: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, Dh), positions (..., S) int; rotates the two halves of
    Dh (not interleaved pairs), in f32."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, device=x.device)            # (dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs         # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                            # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x32 = x.to(torch.float32)
    x1, x2 = x32[..., : dh // 2], x32[..., dh // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _forward_lse(q, k, v, causal, window, q_offset, q_chunk, kv_chunk, backend, scale):
    if backend == "kernel":
        return ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                   return_lse=True, scale=scale)
    return flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                               q_chunk=q_chunk, kv_chunk=kv_chunk, return_lse=True, scale=scale)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with the reference's custom VJP (`blocks._build_flash`):
    the forward keeps (q, k, v, out, lse), O(S·Dh) per head, and the
    backward recomputes the probability tiles from (q, k, lse), so no S × S
    tensor is stored in either direction.  With `backend="kernel"` on a
    CUDA tensor the forward is the CUDA kernel (which writes lse beside
    out), and for bf16 inputs so is the backward; f32 inputs and
    `backend="torch"` take `flash_attention_bwd_ref` over the config's
    chunks.  No double backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, q_chunk, kv_chunk, backend, scale):
        out, lse = _forward_lse(q, k, v, causal, window, q_offset, q_chunk, kv_chunk, backend,
                                scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset)
        ctx.scale = {} if scale is None else {"scale": scale}
        ctx.chunks = dict(q_chunk=q_chunk, kv_chunk=kv_chunk)
        ctx.kernel = backend == "kernel"
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.kernel and q.dtype == torch.bfloat16:
            dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse, dout, **ctx.mask, **ctx.scale)
        else:
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, lse, dout, **ctx.mask,
                                                 **ctx.scale, **ctx.chunks)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,            # (B, Sq, Hq, Dh)
    k: torch.Tensor,            # (B, Skv, Hkv, Dh)
    v: torch.Tensor,            # (B, Skv, Hkv, Dh)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    q_offset: int = 0,
    backend: str = "torch",
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention, GQA without repeating K/V, the scores
    scaled by `scale` (default 1/√Dh).

    `backend="kernel"` runs the forward in the CUDA kernel on a CUDA tensor
    (its tiles replace the chunk sizes); otherwise the plain version runs
    with chunks of `q_chunk` × `kv_chunk`, which never materialises the
    S × S scores.  When grad is enabled and an input requires it, the call
    is `FlashAttentionFn` (forward with lse, then the backward: the CUDA
    kernel for bf16 with `backend="kernel"`, else the plain chunked one)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset, q_chunk, kv_chunk,
                                      backend, scale)
    if backend == "kernel":
        return ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                   scale=scale)
    return flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                               q_chunk=q_chunk, kv_chunk=kv_chunk, scale=scale)


def decode_attention(
    q: torch.Tensor,            # (B, 1, Hq, Dh_k)
    k_cache: torch.Tensor,      # (B, S, Hkv, Dh_k)
    v_cache: torch.Tensor,      # (B, S, Hkv, Dh_v)
    cache_len: int,             # valid prefix length
    *,
    window: Optional[int] = None,
    scale_dh: Optional[int] = None,
    seq_shard=(None, 0, 1),
) -> torch.Tensor:
    """Single-token attention over a (ring-buffered) KV cache, in f32.

    `seq_shard` = (mesh, r, n) with n > 1: the cache holds block r of the
    n blocks of its slots (the slot dim split over "model",
    `dist.sharding.kv_seq_shard`).  Each rank then scores its own slots,
    masked at their global indices r·S + j, forms an f32 partial (max,
    sum, out) and the ranks merge them over "model" through the
    log-sum-exp; no rank holds the whole cache."""
    b, s, hkv, dh = k_cache.shape
    hq = q.shape[2]
    g = hq // hkv
    mesh, r, n = seq_shard
    scale = 1.0 / math.sqrt(scale_dh or dh)
    qg = q.reshape(b, hkv, g, dh).to(torch.float32)
    pos = torch.arange(s, device=q.device) + r * s
    valid = pos < cache_len
    if window is not None:
        valid &= pos >= cache_len - window
    s_ = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.to(torch.float32)) * scale
    s_ = torch.where(valid, s_, NEG_INF)
    v32 = v_cache.to(torch.float32)
    if n == 1:
        out = torch.einsum("bhgk,bkhd->bhgd", torch.softmax(s_, dim=-1), v32)
    else:
        m = s_.amax(dim=-1, keepdim=True)                          # (B, Hkv, g, 1)
        p = torch.where(valid, torch.exp(s_ - m), 0.0)
        part = torch.cat([p.sum(dim=-1, keepdim=True),
                          torch.einsum("bhgk,bkhd->bhgd", p, v32)], dim=-1)
        top = shard_rules.all_reduce_max_(m.clone(), mesh, "model")
        part = shard_rules.all_reduce_sum_(part * torch.exp(m - top), mesh, "model")
        out = part[..., 1:] / part[..., :1]
    return out.reshape(b, 1, hq, v_cache.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# checkpointing and the chunked cross-entropy
# ---------------------------------------------------------------------------

def _needs_grad(tree) -> bool:
    if isinstance(tree, (torch.Tensor, shard_rules.LayerShard)):
        return tree.requires_grad
    if isinstance(tree, dict):
        return any(_needs_grad(t) for t in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_needs_grad(t) for t in tree)
    return False


def remat(fn: Callable, *args):
    """fn(*args) under `torch.utils.checkpoint` (non-reentrant) when grad is
    enabled and a tensor among the args (or in a dict / list of them)
    requires it: the reference's `jax.checkpoint`, which keeps the inputs
    and recomputes the body in the backward.  A plain call otherwise, so
    the serving steps run no checkpoint machinery."""
    if torch.is_grad_enabled() and _needs_grad(args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _xent_chunk(xc: torch.Tensor, head: torch.Tensor, tc: torch.Tensor):
    """(Σ nll, count) over one chunk's unmasked targets: nll = lse − gold,
    from one (B, chunk, V) f32 logits tile and reductions only."""
    logits = (xc @ head.to(xc.dtype)).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(tc, min=0)[..., None])[..., 0]
    mask = (tc >= 0).to(torch.float32)
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def chunked_xent_sums(
    x: torch.Tensor,            # (B, T, d) final hidden states (already normed)
    head: torch.Tensor,         # (d, V)
    targets: torch.Tensor,      # (B, T) integer; -1 = ignore
    *,
    chunk: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ token NLL, count) over the targets that are not −1, computed per
    sequence chunk under checkpoint (`remat`) so that only one (B, chunk, V)
    logits tile is ever alive, forward and backward.  T is padded to a
    multiple of the chunk with target −1.  The head is cast to x's dtype
    inside each chunk, as the reference's checkpointed body does."""
    b, t, _ = x.shape
    c = min(chunk, t)
    t_pad = -(-t // c) * c
    targets = targets.to(device=x.device, dtype=torch.long)
    if t_pad != t:
        x = F.pad(x, (0, 0, 0, t_pad - t))
        targets = F.pad(targets, (0, t_pad - t), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, t_pad, c):
        s, n = remat(_xent_chunk, x[:, i:i + c], head, targets[:, i:i + c])
        total, count = total + s, count + n
    return total, count


def chunked_softmax_xent(
    x: torch.Tensor,            # (B, T, d) final hidden states (already normed)
    head: torch.Tensor,         # (d, V)
    targets: torch.Tensor,      # (B, T) integer; -1 = ignore
    *,
    chunk: int = 512,
) -> torch.Tensor:
    """Mean token NLL over the targets that are not −1 (`chunked_xent_sums`);
    the mean divides by max(count, 1)."""
    total, count = chunked_xent_sums(x, head, targets, chunk=chunk)
    return total / torch.clamp(count, min=1.0)


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU-style, or the plain 2-matrix MLP)
# ---------------------------------------------------------------------------

def mlp(params: Dict[str, torch.Tensor], x: torch.Tensor, act: str) -> torch.Tensor:
    if "w_gate" in params:
        h = act_fn(act)(x @ params["w_gate"]) * (x @ params["w_in"])
    else:  # plain 2-matrix MLP (starcoder2-style)
        h = act_fn(act)(x @ params["w_in"])
    return h @ params["w_out"]


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, sort-based capacity dispatch)
# ---------------------------------------------------------------------------

def moe_capacity(n_tokens: int, spec: MoESpec) -> int:
    """Slots per expert.  The round-up to 8 is the reference's, and it
    decides which tokens drop."""
    c = int(math.ceil(n_tokens * spec.top_k * spec.capacity_factor / spec.n_experts))
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """Routing metadata of T tokens over E experts, the T·k choices sorted
    by expert (a stable sort, so each expert's tokens keep token order)."""
    top_e: torch.Tensor     # (T, k) chosen experts, highest probability first
    se: torch.Tensor        # (T·k,) expert of each sorted choice
    stok: torch.Tensor      # (T·k,) its token
    sw: torch.Tensor        # (T·k,) its renormalised weight, f32
    pos: torch.Tensor       # (T·k,) its slot in the expert's queue


def _route(x: torch.Tensor, router: torch.Tensor, spec: MoESpec):
    """Shared routing: (Routing, aux losses), the router in f32."""
    t = x.shape[0]
    e, k = spec.n_experts, spec.top_k
    logits = x.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                           # (T, E)
    top_w, top_e = torch.topk(probs, k, dim=-1)                     # (T, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)                      # as jnp.argsort
    se = flat_e[order]
    # token of each flat choice (t rows of k), written without
    # repeat_interleave / one_hot, whose CPU kernels read the data to size
    # or check their output: the dry run counts the same ops on fake tensors
    stok = torch.arange(t, device=x.device)[:, None].expand(t, k).reshape(-1)[order]
    sw = top_w.reshape(-1)[order]
    starts = torch.searchsorted(se, torch.arange(e, device=x.device))
    pos = torch.arange(t * k, device=x.device) - starts[se]

    me = probs.mean(dim=0)
    ce = (top_e[:, :1] == torch.arange(e, device=x.device)).to(torch.float32).mean(dim=0)
    lb = e * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return Routing(top_e, se, stok, sw, pos), {"moe_lb": lb, "moe_z": z * spec.router_z_coef}


EXPERT_KEYS = ("w_gate", "w_in", "w_out")


def _experts_ffn(params: Dict[str, Any], xe: torch.Tensor, act: str) -> torch.Tensor:
    """The expert FFN on xe (E, c, d) -> (E, c, d).  Over whole (E, d, f)
    stacks one batched product each.  Over a layer's local shards that the
    mesh splits (`LayerShard`, where expert parallelism does not apply):
    with several `model` ranks splitting the feature dims, each rank
    computes its stored columns of every expert (`_experts_on_columns`);
    else expert by expert, each expert's weights gathered alone, so no rank
    holds every expert of the layer at once."""
    w = params["w_in"]
    if not isinstance(w, shard_rules.LayerShard) or not shard_rules.split_axes(w.spec, w.mesh):
        p = {k: (params[k].whole() if isinstance(params[k], shard_rules.LayerShard)
                 else params[k]) for k in EXPERT_KEYS}
        h = act_fn(act)(torch.einsum("ecd,edf->ecf", xe, p["w_gate"])) \
            * torch.einsum("ecd,edf->ecf", xe, p["w_in"])
        return torch.einsum("ecf,efd->ecd", h, p["w_out"])
    if w.model_split and params["w_out"].model_split:
        return _experts_on_columns(params, xe, act, w.mesh, w.seq)
    per = {k: params[k].unbind(0) for k in EXPERT_KEYS}
    out = []
    for j in range(xe.shape[0]):
        h = act_fn(act)(xe[j] @ per["w_gate"][j].whole()) * (xe[j] @ per["w_in"][j].whole())
        out.append(h @ per["w_out"][j].whole())
    return torch.stack(out)


def _experts_on_columns(params: Dict[str, Any], xe: torch.Tensor, act: str, mesh,
                        seq: bool) -> torch.Tensor:
    """Every expert's FFN tensor-parallel over "model" on the stored column
    blocks (gathered over the DP axes only): this rank's f / n columns of
    the gate and input products, the hidden state gathered along f, its
    d / n columns of the output, gathered along d.  The gathered hidden
    state meets this rank's own d-block of `w_out`, so each rank's gradient
    of it is a part of the whole: its gather's backward sums them over
    `model` and keeps this rank's f-block (`GatherRows`, a reduce-scatter)
    in either case.  xe is the same on every rank of `model`: the whole
    stream (its ranks repeating one loss: the output gather's backward this
    rank's d-block, the input's gradient summed) or the tokens a split
    stream gathered (each rank's share of the loss: the output gather's
    backward a reduce-scatter too)."""
    rows = lambda t: shard_rules.GatherRows.apply(t, mesh, "model", 2)  # noqa: E731
    if seq:
        out = rows
    else:
        xe = shard_rules.SumGrad.apply(xe, mesh, "model")
        out = lambda t: shard_rules.GatherRepl.apply(t, mesh, "model", 2)  # noqa: E731
    p = {k: params[k].block() for k in EXPERT_KEYS}
    h = act_fn(act)(torch.einsum("ecd,edf->ecf", xe, p["w_gate"])) \
        * torch.einsum("ecd,edf->ecf", xe, p["w_in"])
    return out(torch.einsum("ecf,efd->ecd", rows(h), p["w_out"]))


def _moe_compute(params: Dict[str, Any], x: torch.Tensor, spec: MoESpec, act: str, c: int):
    """Dispatch / compute / combine over every expert, x (T, d) -> y (T, d).

    A choice past its expert's capacity `c` drops: its row goes to a sink
    row past the E·c slots, which is cut off before the expert products
    (the reference's out-of-bounds `mode="drop"`; nothing indexes out of
    bounds).  Each token's k contributions are summed in a fixed order,
    ascending expert (the stable sort's), where the reference's
    segment_sum adds them; no atomics, so a run repeats bit for bit."""
    t, d = x.shape
    e, k = spec.n_experts, spec.top_k
    r, aux = _route(x, params["router"], spec)
    keep = r.pos < c
    dest = torch.where(keep, r.se * c + r.pos, e * c)               # drop -> sink row
    xe = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    xe[dest] = x[r.stok]
    xe = xe[: e * c].reshape(e, c, d)
    ye = _experts_ffn(params, xe, act).reshape(e * c, d)
    return _combine(ye, r, keep, dest, t, k, x.dtype), aux


def _combine(ye: torch.Tensor, r: Routing, keep: torch.Tensor, dest: torch.Tensor,
             t: int, k: int, dtype) -> torch.Tensor:
    """y (T, d): each token's kept expert rows of ye, weighted and summed in
    a fixed order (ascending expert, the stable sort's)."""
    gathered = ye[torch.where(keep, dest, 0)] * keep[:, None].to(dtype)
    contrib = gathered * r.sw[:, None].to(dtype)                    # (T·k, d), sorted
    mine = torch.argsort(r.stok, stable=True).reshape(t, k)
    y = contrib[mine[:, 0]]
    for j in range(1, k):
        y = y + contrib[mine[:, j]]
    return y


def _moe_a2a_block(params: Dict[str, torch.Tensor], x_my: torch.Tensor, spec: MoESpec,
                   act: str, mesh, n_model: int):
    """Token-split all-to-all expert parallelism on this rank's DISJOINT
    token slice x_my (T_my, d): route over all E experts, build an
    (n_model, E_loc, c, d) send buffer, all-to-all it over `model` so each
    rank receives its experts' tokens from every peer, run the expert FFN
    on its E_loc experts (`params`' expert weights hold only those), send
    the results back the same way and combine locally.  The capacity c is
    the local slice's, as the reference's."""
    e, k = spec.n_experts, spec.top_k
    e_loc = e // n_model
    t_my, d = x_my.shape
    r, aux = _route(x_my, params["router"], spec)
    c = moe_capacity(t_my, spec)
    keep = r.pos < c
    dest = torch.where(keep, r.se * c + r.pos, e * c)               # drop -> sink row
    send = torch.zeros((e * c + 1, d), dtype=x_my.dtype, device=x_my.device)
    send[dest] = x_my[r.stok]
    send = send[: e * c].reshape(n_model, e_loc, c, d)
    # block j of dim 0 goes to the owner of experts j·E_loc.., block i of
    # the result came from rank i
    recv = shard_rules.AllToAll.apply(send, mesh, "model")
    recv = recv.transpose(0, 1).reshape(e_loc, n_model * c, d)
    ye = _experts_ffn(params, recv, act)                            # (E_loc, n_model·c, d)
    back = ye.reshape(e_loc, n_model, c, d).transpose(0, 1).contiguous()
    ye_my = shard_rules.AllToAll.apply(back, mesh, "model").reshape(e * c, d)
    return _combine(ye_my, r, keep, dest, t_my, k, x_my.dtype), aux


def moe_layer(params: Dict[str, Any], x: torch.Tensor, spec: MoESpec, act: str):
    """x (B, S, d) -> (y (B, S, d), aux dict), dropped-on-overflow capacity.

    With whole expert stacks: the reference's single-device path over the
    B·S tokens.  With expert stacks given as a rank's local shards
    (`LayerShard`, as the meshed steps hand them), the layer runs on their
    mesh and x holds this rank's rows (its DP shard when the batch
    splits): this rank's sequence block of them where the stream is split
    over `model` (`LayerShard.seq`), else every position, the same on
    every rank of `model`.  Expert parallelism runs under the reference's
    conditions (more than one `model` rank, E and S divisible by it, the
    batch split over the DP axes or no DP axis): this rank takes its
    E/n_model experts (`_local_experts`), exchanges its S/n_model tokens
    with the expert owners (`_moe_a2a_block`) — the token-split stream
    directly, or its slice of the whole stream, gathered back after — and
    the aux terms are the mean over every rank (the reference's pmean).
    Otherwise, when the batch splits over the DP axes, the tokens are
    gathered and dispatched over the whole batch, with the capacity of the
    whole batch, as the reference's unsplit program computes them, and each
    rank keeps its rows (a split stream is gathered over `model` first and
    each rank keeps its block); the gathers' backward is a reduce-scatter,
    so a train step's gradients, averaged over the DP axes, are the whole
    batch's."""
    b, s, d = x.shape
    w = params["w_in"]
    if isinstance(w, shard_rules.LayerShard):
        mesh, split = w.mesh, w.rows_split
        e = spec.n_experts
        n_model = shard_rules.axis_size(mesh, "model")
        dax = shard_rules.batch_axes(mesh)
        n_data = shard_rules.axis_size(mesh, dax)
        ep = n_model > 1 and e % n_model == 0 and (split or n_data == 1)
        if w.seq:
            if ep:
                return _moe_expert_parallel(params, x, spec, act, mesh, dax, n_model, seq=True)
            xg = shard_rules.GatherRows.apply(x, mesh, "model", 1)
            y, aux = _moe_rows(params, xg, spec, act, mesh, split, dax, n_data)
            return shard_rules.BlockRows.apply(y, mesh, "model", 1), aux
        if ep and s % n_model == 0:
            return _moe_expert_parallel(params, x, spec, act, mesh, dax, n_model)
        return _moe_rows(params, x, spec, act, mesh, split, dax, n_data)
    y, aux = _moe_compute(params, x.reshape(b * s, d), spec, act, moe_capacity(b * s, spec))
    return y.reshape(b, s, d), aux


def _moe_rows(params, x, spec: MoESpec, act: str, mesh, split: bool, dax, n_data: int):
    """The dispatch over every token of the batch: gathered over the DP
    axes where the rows split (each rank keeps its rows), else on x."""
    b, s, d = x.shape
    if split and n_data > 1:
        xg = shard_rules.GatherRows.apply(x, mesh, dax, 0)
        y, aux = _moe_compute(params, xg.reshape(-1, d), spec, act,
                              moe_capacity(xg.shape[0] * s, spec))
        return shard_rules.BlockRows.apply(y.reshape(xg.shape), mesh, dax, 0), aux
    y, aux = _moe_compute(params, x.reshape(b * s, d), spec, act, moe_capacity(b * s, spec))
    return y.reshape(b, s, d), aux


def _local_experts(w: shard_rules.LayerShard, mesh, n_model: int) -> torch.Tensor:
    """This rank's E/n_model experts, whole in their feature dims, of a
    rank's stored shard of a layer's expert stack ((E, d, f) with the
    feature dims split over the DP axes and "model"): gathered over the DP
    axes, then one all-to-all over "model" that moves the split from the
    feature dim to E (the reshard the reference's `P("model")` in_specs ask
    for; the backward is the inverse all-to-all, then the gather's
    adjoint)."""
    fd = next((dim for dim, ax in enumerate(w.spec) if ax == "model"), None)
    t = w.block()
    if fd is None:                                    # the features are not split over model
        return shard_rules.SplitRepl.apply(t, mesh, "model", 0)
    return shard_rules.move_split(t, mesh, "model", fd, 0)


def _moe_expert_parallel(params, x, spec: MoESpec, act: str, mesh, dax, n_model: int,
                         seq: bool = False):
    """Expert parallelism over "model".  `seq`: x is already this rank's
    token block of a stream split by sequence, whose ranks each hold their
    own share of the loss (the router's whole read sums its gradient over
    "model"); else x is the whole stream, which every rank repeats, and this
    rank takes its slice of it and gathers the slices back."""
    b, _, d = x.shape
    split, gather = shard_rules.SplitRepl.apply, shard_rules.GatherRepl.apply
    if seq:
        x_my, p = x, {"router": params["router"]}
    else:
        x_my = split(x, mesh, "model", 1)                          # (b, s/n, d)
        p = {"router": shard_rules.SumGrad.apply(params["router"], mesh, "model")}
    for name in EXPERT_KEYS:
        p[name] = _local_experts(params[name], mesh, n_model)     # this rank's experts
    y_my, aux = _moe_a2a_block(p, x_my.reshape(-1, d), spec, act, mesh, n_model)
    y_my = y_my.reshape(x_my.shape)
    y = y_my if seq else gather(y_my, mesh, "model", 1)
    every = ("model",) + shard_rules.as_axes(dax)
    shared = () if seq else "model"
    return y, {k: shard_rules.MeanRepl.apply(v, mesh, every, shared) for k, v in aux.items()}


# ---------------------------------------------------------------------------
# param helpers
# ---------------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def cast(params: Dict[str, torch.Tensor], cdt: torch.dtype) -> Dict[str, torch.Tensor]:
    """The reference's cast rule: f32 leaves with ndim >= 2 -> compute dtype."""
    return {k: (t.to(cdt) if t.dtype == torch.float32 and t.ndim >= 2 else t)
            for k, t in params.items()}


def cast_stacked(lp: Dict[str, torch.Tensor], cdt: torch.dtype) -> Dict[str, torch.Tensor]:
    """A layer's leaves under the cast rule as the reference's training
    forward applies it: to the stacked `[L, ...]` leaves, where every leaf
    has ndim >= 2, so the layer's f32 vectors (norms, mixes, biases) are
    cast to the compute dtype too (its serving steps cast layer by layer,
    `cast`, and keep them f32)."""
    return {k: (t.to(cdt) if t.dtype == torch.float32 else t) for k, t in lp.items()}


def layer_params(params: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer i's leaves of the stacked `[L, ...]` layout (on a mesh, layer
    i's local shards, `dist.sharding.LayerShard`: `gather_layer` makes them
    whole)."""
    return {k: t[i] for k, t in params["layers"].items()}


def unstacked(params: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every layer's leaves of the stacked layout, as views from one
    `unbind` per leaf: the backward then stacks each leaf's layer
    gradients once, where indexing layer by layer would add a full-size
    gradient per layer.  On a mesh, each layer's local shards."""
    per_leaf = {k: t.unbind(0) for k, t in params["layers"].items()}
    n = len(next(iter(per_leaf.values())))
    return [{k: ts[i] for k, ts in per_leaf.items()} for i in range(n)]


def gather_layer(lp: Dict[str, Any], keep=()) -> Dict[str, Any]:
    """A layer's leaves, each local shard gathered whole
    (`LayerShard.whole`) but those named in `keep` (the MoE expert stacks,
    which `moe_layer` gathers its own way); plain tensors as they are.
    Called inside the layer's body, so under `remat` the backward's
    recompute gathers again.  A transformer split over several `model`
    ranks reads its leaves in their compute layouts instead
    (`transformer._layer_tp`)."""
    return {k: (v.whole() if isinstance(v, shard_rules.LayerShard) and k not in keep else v)
            for k, v in lp.items()}


def embed(params: Dict[str, Any], tokens: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """The token embeddings (..., d) of integer `tokens` in the compute dtype,
    on the embedding table's device."""
    table = shard_rules.read_whole(params["embed"])
    return table[tokens.to(device=table.device, dtype=torch.long)].to(cdt)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1/d_in) (or N(0, scale²)) draws on the generator's device."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=gen.device)
    return (w * s).to(dtype)


def stacked(layer_fn: Callable[[int], Dict[str, torch.Tensor]], n: int
            ) -> Dict[str, torch.Tensor]:
    """Stack per-layer inits along a leading `layers` axis.  The stacked
    tensors are allocated once and filled layer by layer, so at most one
    layer's leaves exist twice."""
    first = layer_fn(0)
    out = {name: torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
           for name, t in first.items()}
    for name, t in first.items():
        out[name][0] = t
    del first
    for i in range(1, n):
        for name, t in layer_fn(i).items():
            out[name][i] = t
    return out
