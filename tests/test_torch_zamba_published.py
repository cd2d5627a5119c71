"""Zamba2's published layout in the port (`models/ssm.py`, `SharedBlocksSpec`
and `GroupedSSMSpec`) against the benchmark's plain reference
(`portbench/reference/zamba.py`), at a small width with every mechanism
present: 2 shared blocks in alternation over 3 uses, per-use adapters and
output Linears, 2 groups of B and C, the gate before the group norm, heads
of Dh = 2·d / heads, scores scaled by (Dh / 2)^-1/2, a tied head.

The port runs through `models/api.py` on the kernel backend (its plain
versions on the CPU), with Mamba-2's own init (A from [1, 16], the dt bias
from the published time-step range), so states carry over hundreds of
positions.  Checked, in f32 and bf16: the prefill's last logits and every
cache leaf; a prefill, then decode steps, against the reference's one
forward over the prompt and the fed tokens; the reference's dual-form SSM
against the step recurrence; and four ablations, planted in the port's
weights (one in its gated norm), each of which moves the logits far past
the tolerance and equals the reference's own ablation (so the benchmark's
faults, which ablate the reference, plant what they say)."""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from portbench.families import zamba as family
from portbench.reference import zamba as ref
from repro_torch.configs.zamba2_7b import PUBLISHED
from repro_torch.core.execution import Execution
from repro_torch.models import api, ssm

EXE = Execution(device="cpu", backend="kernel")

# every mechanism, small: d 64, 2 heads of 64 on the 128-wide concat, scale
# 32^-1/2; 7 layers with uses at 1, 3, 5 (blocks 0, 1, 0); 8 SSD heads of 16
# in 2 groups of d_state 8
CFG = dataclasses.replace(
    PUBLISHED, name="zamba2-tiny", n_layers=7, d_model=64, n_heads=2, n_kv_heads=2, head_dim=64,
    d_ff=96, vocab_size=256, compute_dtype="float32", q_chunk=32, kv_chunk=32,
    ssm=dataclasses.replace(PUBLISHED.ssm, d_state=8, head_dim=16),
    hybrid=dataclasses.replace(PUBLISHED.hybrid, layer_ids=(1, 3, 5), adapter_rank=4))
ABLATIONS = ("adapters", "block0", "one_group", "norm_then_gate")

# (logits, cache leaves) relative-norm tolerances against the f32
# reference: f32 differs only in the order of sums (chunked SSD and flash
# against the dual form and a plain softmax); bf16 rounds every product's
# inputs and the residual stream to 8 bits, about 2^-8 relative a product
# over 7 layers
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1.5e-2, 5e-2)}


def _arch(cfg):
    """The reference's sizes of a port config."""
    s, h = cfg.ssm, cfg.hybrid
    return family.Arch(
        name=cfg.name, family="zamba", n_layers=cfg.n_layers, d_model=cfg.d_model, d_ff=cfg.d_ff,
        vocab_size=cfg.vocab_size, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, act=cfg.act, norm_eps=cfg.norm_eps,
        tie_embeddings=cfg.tie_embeddings, param_dtype=cfg.param_dtype,
        compute_dtype=cfg.compute_dtype, vocab_pad_to=cfg.vocab_pad_to, q_chunk=cfg.q_chunk,
        kv_chunk=cfg.kv_chunk, d_state=s.d_state, d_conv=s.d_conv, expand=s.expand,
        ssm_head_dim=s.head_dim, n_groups=s.n_groups, hybrid_layer_ids=h.layer_ids,
        n_blocks=h.n_blocks, adapter_rank=h.adapter_rank)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


@pytest.fixture(scope="module")
def params():
    return api.init_params(torch.Generator().manual_seed(7), CFG, execution=EXE)


def _tokens(s, seed=1, b=2):
    return torch.randint(0, CFG.vocab_size, (b, s), generator=torch.Generator().manual_seed(seed))


def test_the_layout_and_its_count(params):
    """The published spec's own leaves, their count as `param_count` and the
    benchmark's family have them, and the registry's zamba2_7b untouched."""
    assert ssm.published(CFG) and not ssm.published(dataclasses.replace(CFG, hybrid=None))
    assert CFG.dh == 2 * CFG.d_model // CFG.n_heads
    assert set(params["shared"]["wq"].shape[:1]) == {2} and params["hybrid"]["proj"].shape[0] == 3
    assert "lm_head" not in params
    n = sum(t.numel() for grp in params.values()
            for t in (grp.values() if isinstance(grp, dict) else [grp]))
    assert n == CFG.param_count() == api.exact_param_counts(CFG)[0]
    specs = {p: shape for p, shape, _ in family.leaf_specs(_arch(CFG))}
    flat = {f"{g}/{k}" if isinstance(t, dict) else g: None
            for g, t in params.items() for k in (t if isinstance(t, dict) else [g])}
    assert set(specs) == set(flat)
    for path, shape in specs.items():
        g, *k = path.split("/")
        assert tuple((params[g][k[0]] if k else params[g]).shape) == shape, path
    assert PUBLISHED.param_count() == 7_356_749_648


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [128, 100])            # the block form; the step form
def test_prefill_logits_and_every_cache_leaf(params, dtype, s):
    cfg = dataclasses.replace(CFG, compute_dtype=dtype)
    tok = _tokens(s)
    logits, cache = api.prefill(params, {"tokens": tok}, cfg, s + 4, execution=EXE)
    a = _arch(cfg)
    want = ref.last_logits(params, a, None, tok, "f32")
    tol_logits, tol_leaf = TOL[dtype]
    assert _rel(logits, want) <= tol_logits, _rel(logits, want)
    states = ref.prefill_states(params, a, tok, "f32")
    assert int(cache["len"]) == s and int(cache["pos"]) == s
    for leaf in ("ssm", "conv", "k", "v"):
        got = cache[leaf] if leaf in ("ssm", "conv") else cache[leaf][:, :, :s]
        assert got.shape == states[leaf].shape, leaf
        assert _rel(got, states[leaf]) <= tol_leaf, (leaf, _rel(got, states[leaf]))
    assert bool((cache["k"][:, :, s:] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_against_one_forward(params, dtype):
    cfg = dataclasses.replace(CFG, compute_dtype=dtype)
    s, steps = 64, 5
    tok = _tokens(s, seed=2)
    logits, cache = api.prefill(params, {"tokens": tok}, cfg, s + steps, execution=EXE)
    fed, got = [logits.argmax(-1)], [logits]
    for _ in range(steps):
        lg, cache = api.decode_step(params, fed[-1], cache, cfg, execution=EXE)
        got.append(lg)
        fed.append(lg.argmax(-1))
    stream = torch.cat([tok, torch.stack(fed[:-1], dim=1)], dim=1)
    want = ref.stream_logits(params, _arch(cfg), None, stream, s - 1, "f32")
    assert want.shape[1] == steps + 1
    for t, lg in enumerate(got):
        assert _rel(lg, want[:, t]) <= TOL[dtype][0], (t, _rel(lg, want[:, t]))


def test_the_dual_form_is_the_step_recurrence():
    """Over 300 positions with Mamba-2's dt bias (log-uniform in the
    published [1e-3, 1e-1], floor 1e-4) and A from [1, 16]: decays near 1,
    so every position's state reaches far back."""
    g = torch.Generator().manual_seed(11)
    b, s, nh, dh, grp, ds = 2, 300, 6, 8, 2, 5
    dt_bias = ssm._dt_bias(g, nh)
    assert bool(((dt_bias > math.log(math.expm1(ssm.DT_FLOOR))) &
                 (dt_bias < math.log(math.expm1(ssm.DT_MAX)) + 1e-4)).all())
    x = torch.randn((b, s, nh, dh), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((b, s, nh), generator=g) * 0.1 + dt_bias)
    a = -(torch.rand((nh,), generator=g) * 15 + 1)
    bm, cm = torch.randn((b, s, grp, ds), generator=g), torch.randn((b, s, grp, ds), generator=g)
    assert float(torch.exp(dt * a).max()) > 0.99            # memories of hundreds of positions
    got = ref.ssd_dual(x, dt, a, bm, cm, "f32")
    want, state = ref.ssd_recurrent(x, dt, a, bm, cm)
    assert _rel(got, want) <= 1e-5, _rel(got, want)
    assert _rel(ref.final_state(x, dt, a, bm), state) <= 1e-5
    # the last position still reads the first: zeroing x_0 moves y_{s-1}
    x0 = x.clone()
    x0[:, 0] = 0
    assert _rel(ref.ssd_dual(x0, dt, a, bm, cm, "f32")[:, -1], got[:, -1]) > 1e-6


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("block", [True, False])
def test_the_groups_in_the_batch_are_each_group_s_own_scan(g, block):
    """`ssm._ssd` with g groups of B and C folded into the batch equals one
    scan a group over that group's heads, from a carried-in state."""
    gen = torch.Generator().manual_seed(13)
    b, s, nh, dh, ds = 2, 2 * ssm.SSD_CHUNK, 8, 4, 3
    xh = torch.randn((b, s, nh, dh), generator=gen)
    bm, cm = torch.randn((b, s, g * ds), generator=gen), torch.randn((b, s, g * ds), generator=gen)
    dt = torch.rand((b, s, nh), generator=gen) * 0.1
    a = -(torch.rand((nh,), generator=gen) * 15 + 1)
    state = torch.randn((b, nh, dh, ds), generator=gen)
    ys, out = ssm._ssd(xh, bm, cm, dt, a, state, g, block)
    k = nh // g
    for j in range(g):
        hs, cs = slice(j * k, (j + 1) * k), slice(j * ds, (j + 1) * ds)
        yj, oj = ssm._ssd(xh[:, :, hs], bm[..., cs], cm[..., cs], dt[..., hs], a[hs],
                          state[:, hs], 1, block)
        assert torch.allclose(ys[:, :, hs], yj, rtol=1e-5, atol=1e-5), j
        assert torch.allclose(out[:, hs], oj, rtol=1e-5, atol=1e-5), j


def _norm_then_gate(y, z, w, g, eps):
    """`ssm._gated_group_norm` with the norm before the gate."""
    y32 = y.to(torch.float32)
    grp = y32.reshape(*y32.shape[:-1], g, -1)
    y32 = (grp * torch.rsqrt(torch.mean(torch.square(grp), dim=-1, keepdim=True) + eps)
           ).reshape(y32.shape) * torch.nn.functional.silu(z.to(torch.float32))
    return (y32.to(y.dtype).to(torch.float32) * w.to(torch.float32)).to(y.dtype)


def _ablated(params, ablation, monkeypatch):
    """The port's weights with one mechanism left out: the adapters' B
    zeroed; block 1's leaves block 0's; group 1's B and C columns (of
    `in_proj`, the conv's taps and bias) group 0's; or the group norm
    moved before the gate."""
    out = {g: dict(t) if isinstance(t, dict) else t for g, t in params.items()}
    if ablation == "adapters":
        out["hybrid"]["adapter_b"] = torch.zeros_like(params["hybrid"]["adapter_b"])
    elif ablation == "block0":
        out["shared"] = {k: t[:1].expand_as(t).clone() for k, t in params["shared"].items()}
    elif ablation == "one_group":
        di, ds = CFG.ssm.d_inner(CFG.d_model), CFG.ssm.d_state
        for leaf, at in (("in_proj", 2 * di), ("conv_w", di), ("conv_b", di)):
            t = params["layers"][leaf].clone()
            for c in (at, at + 2 * ds):             # B's groups, then C's
                t[..., c + ds:c + 2 * ds] = t[..., c:c + ds]
            out["layers"][leaf] = t
    else:
        monkeypatch.setattr(ssm, "_gated_group_norm", _norm_then_gate)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ablation", ABLATIONS)
def test_each_mechanism_is_computed(params, dtype, ablation, monkeypatch):
    """The port with one mechanism left out is far from the whole
    reference, and equal to the reference that leaves out the same one (the
    benchmark's faults, which ablate the reference)."""
    s = 128
    tok = _tokens(s, seed=3)
    cfg = dataclasses.replace(CFG, compute_dtype=dtype)
    got, _ = api.prefill(_ablated(params, ablation, monkeypatch), {"tokens": tok}, cfg, s,
                         execution=EXE)
    a = _arch(CFG)
    whole = ref.last_logits(params, a, None, tok, "f32")
    same = ref.last_logits(params, dataclasses.replace(a, ablate=(ablation,)), None, tok, "f32")
    tol = TOL[dtype][0]
    assert _rel(got, whole) > 3 * tol, (ablation, _rel(got, whole))
    assert _rel(got, same) <= tol, (ablation, _rel(got, same))
