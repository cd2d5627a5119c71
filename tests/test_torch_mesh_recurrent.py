"""The port's recurrent families split over `model` as the reference pins
them, on gloo ranks spawned on the CPU: Zamba-2's Mamba-2 layers by SSD
head (z, xs and dt from each rank's `in_proj` columns, B and C whole on
every rank, `norm_y` across the ranks, `out_proj` row-parallel), its shared
attention + MLP block by head and by d_ff, and its training carry by
feature (B_local, S, d / n_model); RWKV-6's time mix by WKV head (`ln_x`
across the ranks, `wo` row-parallel) and its channel mix by d_ff, on a
whole stream.

Meshes (1, 4) and (2, 2), one spawn of `tests/torch_mesh_ranks.py`'s
`mesh_recurrent` scenario each.  The configs are SMOKE ones with `ZAMBA` /
`RWKV` dims (so heads divide 4 and the allocation guard's shapes stay
apart): zamba2 has 8 SSD heads and 2 shared heads, so on (1, 4) the shared
attention takes the degrade path (every head on every rank) while its MLP
splits, and on (2, 2) both split; `zamba-degrade` has SSD heads of 64
(2 heads), which 4 ranks do not divide, so its Mamba-2 layers run whole on
every rank while the carry still splits; rwkv6 at d_model 256 has 4 WKV
heads.  Mamba-2's block-form chunk is 8 in both packages (`SSD_CHUNK`), so
training runs the chunked form under checkpoint, prefill the batched block
form and decode the step form.  A train step is held to the reference's
unmeshed step — loss, grad_norm and lr at rtol 1e-5 each step on every
rank, every state leaf after two steps within 5e-4 in relative norm (in
bf16 within max(2e-2, BF16_K x the reference's own bf16-against-f32
distance on the leaf), at most `BF16_NAMED`'s ceiling:
`test_the_bf16_gap_is_the_reference_s_own_rounding`,
`test_unmeshed_step_witnesses_the_bf16_bounds`); the reference's meshed LM
steps fail with this JAX (ROADMAP C7).  Serving: prefill + 6 teacher-forced
decode steps against the reference's unmeshed `api` steps, logits at 1e-4
every step on every rank and every cache leaf at the end in each rank's
own block.  On every rank
the allocation guard finds no whole matrix that the split reads in part,
zamba2's layers keep (B_local, S, d / n_model) for the backward and
rwkv6's the whole stream; on (1, 4) one layer of either family does at
most 0.35 of the unmeshed layer's matmul FLOPs on a rank."""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models import api as j_api
from repro.models import ssm as j_ssm
from repro.train import optimizer as j_opt
from repro.train import train_step as j_ts
from repro_torch import bridge
from repro_torch import tree as t_tree
from repro_torch.core.execution import Execution
from repro_torch.data import synthetic as t_synthetic
from repro_torch.dist import sharding as t_sharding
from repro_torch.models import api as t_api
from repro_torch.train import optimizer as t_opt
from repro_torch.train import train_step as t_ts
from repro_torch.train import trainer as t_trainer
from test_torch_mesh import _reference_step
from torch_lm_parity import configs, np_tree, request
from torch_mesh_ranks import spawn

TRAJ = {"float32": 5e-4, "bfloat16": 2e-2}
# bf16 zamba2 after two AdamW steps from the reference's own state: the
# reference's bf16 step lies as far from its own f32 step as the port's
# lies from it (the port at 0.43 to 1.33 times the reference's own
# distance on the leaves it moves past 1e-3, the (1, 4) split at 0.94 to
# 1.36 on the six below; `test_the_bf16_gap_is_the_reference_s_own_rounding`),
# so a leaf's bound is max(2e-2, BF16_K x that distance): two roundings of
# equal size, independent, lie sqrt(2) times as far apart as either lies
# from f32.  The rule alone would raise four of the six bounds first set by
# hand from the readings (d_skip's v and m, conv_b's v, dt_bias's m: its
# values, 0.0759, 0.0464, 0.0356, 0.0307), so those stay the ceilings
# below; the rule lowers conv_b's bound to 0.0841 and a_log's v to
# 0.0222.  `conv_b`
# starts at zero, so AdamW's first step leaves ±lr by its gradient's sign,
# and bf16 flips the sign of gradients near zero; the rest are gradient
# statistics of few-element leaves (v reads the squared gradient).  In f32
# every leaf is within 6e-6.  The readings, (1, 4) split / unmeshed / the
# reference's own, are beside each ceiling (`tests/torch_bf16_gap.py`).
BF16_K = 2 ** 0.5
BF16_NAMED = {
    ".params['layers']['conv_b']": 0.1,     # 0.0776 / 0.0793 / 0.0595
    ".opt.v['layers']['d_skip']": 0.07,     # 0.0507 / 0.0462 / 0.0537
    ".opt.m['layers']['d_skip']": 0.045,    # 0.0326 / 0.0311 / 0.0328
    ".opt.v['layers']['conv_b']": 0.035,    # 0.0243 / 0.0228 / 0.0252
    ".opt.v['layers']['a_log']": 0.03,      # 0.0213 / 0.0132 / 0.0157
    ".opt.m['layers']['dt_bias']": 0.03,    # 0.0199 / 0.0191 / 0.0217
}
METRIC_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
SSD_CHUNK = 8

MESHES = {"1x4": ((1, 4), ("data", "model")), "2x2": ((2, 2), ("data", "model"))}

# The allocation guard tells a whole matrix by its shape, so the cases keep
# the activations' and the head's shapes off those: a vocabulary of 768,
# zamba2's shared d_ff 160 and shared heads of 20 (2 x 20 = 40 is neither
# d_model nor B_local·S), rwkv6's d_ff 320; serving at batch 2 (at 4, decode's
# gathered (B, 1, C) conv output has `conv_w`'s (K, 1, C) shape).
ZAMBA = {"vocab_size": 768, "d_ff": 160, "head_dim": 20}
RWKV = {"vocab_size": 768, "d_model": 256, "d_ff": 320}
# name -> (arch, dims, compute dtype, SSD head_dim or None)
TRAIN = {
    "zamba": ("zamba2_7b", ZAMBA, "float32", None),
    "zamba-bf16": ("zamba2_7b", ZAMBA, "bfloat16", None),
    "zamba-degrade": ("zamba2_7b", ZAMBA, "float32", 64),
    "rwkv6": ("rwkv6_1b6", RWKV, "float32", None),
}
SERVE = {"zamba": ("zamba2_7b", ZAMBA), "rwkv6": ("rwkv6_1b6", RWKV)}
PLAN = {
    "1x4": (["zamba", "zamba-bf16", "zamba-degrade", "rwkv6"], ["zamba", "rwkv6"]),
    "2x2": (["zamba", "rwkv6"], ["zamba", "rwkv6"]),
}
# one layer a family, 4 × 32 tokens; zamba2 with 4 shared heads so its
# shared attention splits on (1, 4) too
FLOPS = {"zamba": ("zamba2_7b", dict(ZAMBA, n_heads=4, n_kv_heads=4)),
         "rwkv6": ("rwkv6_1b6", RWKV)}


@pytest.fixture(scope="module")
def ssd_chunk():
    """The reference's Mamba-2 block-form chunk set to SSD_CHUNK while its
    steps are traced (the ranks set the port's)."""
    own = j_ssm.SSD_CHUNK
    j_ssm.SSD_CHUNK = SSD_CHUNK
    yield SSD_CHUNK
    j_ssm.SSD_CHUNK = own


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _cfgs(arch, dims, dtype, ssd_head=None):
    jc, tc = configs(arch, dtype, **dims)
    if ssd_head is not None:
        jc, tc = (dataclasses.replace(c, ssm=dataclasses.replace(c.ssm, head_dim=ssd_head))
                  for c in (jc, tc))
    return jc, tc


def _leaves(tree):
    return {jax.tree_util.keystr(kp): np.asarray(l)
            for kp, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def references(ssd_chunk):
    """Per train case: the port's inputs and the reference's two unmeshed
    steps (its state after each)."""
    out = {}
    for name, (arch, dims, dtype, ssd_head) in TRAIN.items():
        jc, tc = _cfgs(arch, dims, dtype, ssd_head)
        jcfg = j_ts.TrainConfig(arch=jc, opt=j_opt.AdamWConfig(**TRAIN_OPT))
        tcfg = t_ts.TrainConfig(arch=tc, opt=t_opt.AdamWConfig(**TRAIN_OPT))
        j_state = j_ts.init_state(jax.random.PRNGKey(0), jcfg)
        data = t_synthetic.TokenStreamConfig(vocab_size=jc.vocab_size, seq_len=24,
                                             global_batch=4, seed=3)
        batches = [t_trainer.make_batch(tc, data, i) for i in range(2)]
        inputs = {"tcfg": tcfg, "batches": batches,
                  "state": bridge.train_state_from_reference(np_tree(j_state), device="cpu")}
        step = _reference_step(jcfg)
        metrics, after = [], []
        for b in batches:
            j_state, m = step(j_state, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
            after.append(_leaves(j_state))
        out[name] = (inputs, {"metrics": metrics, "leaves": after[-1], "steps": after})
    return out


@pytest.fixture(scope="module")
def serving(ssd_chunk):
    """Per serving case: the port's inputs, and the reference's logits at
    prefill and each decode step and its final cache."""
    out = {}
    for name, (arch, dims) in SERVE.items():
        jc, tc = _cfgs(arch, dims, "float32")
        inputs, forced, cache_size = request(jc, batch=2, prompt=16)
        params = j_api.init_params(jax.random.PRNGKey(3), jc)
        jb = {k: jnp.asarray(v) for k, v in inputs.items()}
        logits, cache = jax.jit(lambda p, b: j_api.prefill(p, b, jc, cache_size))(params, jb)
        want = [np.asarray(logits)]
        dec = jax.jit(lambda p, t, c: j_api.decode_step(p, t, c, jc))
        for i in range(forced.shape[1]):
            logits, cache = dec(params, jnp.asarray(forced[:, i]), cache)
            want.append(np.asarray(logits))
        case = {"cfg": tc, "params": bridge.params_from_reference(np_tree(params), device="cpu"),
                "batch": {k: torch.from_numpy(v) for k, v in inputs.items()},
                "forced": [torch.from_numpy(forced[:, i]) for i in range(forced.shape[1])],
                "cache_size": cache_size}
        out[name] = (case, {"logits": want, "cache": _leaves(cache)})
    return out


@pytest.fixture(scope="module")
def reference_gap(references):
    """The reference's own bf16 zamba2 state after two steps against its f32
    state after the same two steps from the same state: relative norm per
    float leaf."""
    f32, bf16 = references["zamba"][1]["leaves"], references["zamba-bf16"][1]["leaves"]
    return {p: _rel(bf16[p].astype(np.float32), w.astype(np.float32))
            for p, w in f32.items() if w.dtype.kind == "f"}


def _bound(path, dtype, gap):
    """A leaf's bound: TRAJ in f32; in bf16 max(2e-2, BF16_K x the
    reference's own bf16-against-f32 distance), at most BF16_NAMED's
    ceiling (2e-2 where it names none)."""
    if dtype != "bfloat16":
        return TRAJ[dtype]
    return min(BF16_NAMED.get(path, TRAJ[dtype]), max(TRAJ[dtype], BF16_K * gap[path]))


def _flops_cases():
    out = {}
    for name, (arch, dims) in FLOPS.items():
        _, tc = configs(arch, "float32", n_layers=1, **dims)
        params = t_api.init_params(torch.Generator().manual_seed(1), tc,
                                   execution=Execution(device="cpu"))
        tokens = np.random.default_rng(2).integers(0, tc.vocab_size, (4, 32), dtype=np.int32)
        out[name] = {"cfg": tc, "params": params, "batch": {"tokens": torch.from_numpy(tokens)}}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, references, serving):
    """Every rank's results on each mesh."""
    out = {}
    for mesh_id, (train, serve) in PLAN.items():
        inputs = {"mesh": MESHES[mesh_id], "ssd_chunk": SSD_CHUNK,
                  "train": {n: references[n][0] for n in train},
                  "serve": {n: serving[n][0] for n in serve}}
        if mesh_id == "1x4":
            inputs["flops"] = _flops_cases()
        world = int(np.prod(MESHES[mesh_id][0]))
        d = tmp_path_factory.mktemp(f"mesh_recurrent_{mesh_id}")
        out[mesh_id] = spawn("mesh_recurrent", world, d / "ranks", inputs, timeout=300)
    return out


CASES = [(m, n) for m, (train, _) in PLAN.items() for n in train]
SERVES = [(m, n) for m, (_, serve) in PLAN.items() for n in serve]


def test_ranks_run_without_jax(runs):
    assert not any(r["jax_loaded"] for res in runs.values() for r in res)


@pytest.mark.parametrize("mesh_id,case", CASES)
def test_split_train_step_matches_the_reference(mesh_id, case, runs, references, reference_gap):
    """Two split train steps from the reference's initial state against two
    of the reference's unmeshed steps: the metrics on every rank each step,
    then every state leaf, and each rank's shards in their specs' shapes."""
    want = references[case][1]
    dtype = TRAIN[case][2]
    res = runs[mesh_id]
    for r in res:
        got = r[f"train/{case}"]
        for i, (gm, wm) in enumerate(zip(got["metrics"], want["metrics"])):
            assert set(gm) == set(wm)
            for name in wm:
                np.testing.assert_allclose(gm[name], wm[name], rtol=METRIC_RTOL[dtype], atol=1e-6,
                                           err_msg=f"{name} at step {i}")
        for path, (local, spec_shape) in got["shapes"].items():
            assert local == spec_shape, path
    got = res[0][f"train/{case}"]["leaves"]
    assert set(got) == set(want["leaves"])
    far = []
    for path, w in want["leaves"].items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            rel = _rel(g.astype(np.float32), w.astype(np.float32))
            if rel > _bound(path, dtype, reference_gap):
                far.append((path, rel))
    assert far == [], far


@pytest.fixture(scope="module")
def unmeshed(references):
    """The port's own unmeshed zamba2 step from the reference's state, per
    f32 / bf16 case: its state leaves after each of the two steps."""
    out = {}
    for case in ("zamba", "zamba-bf16"):
        inputs = references[case][0]
        step = t_ts.make_train_step(inputs["tcfg"], execution=Execution(device="cpu"))
        state, got = copy.deepcopy(inputs["state"]), []
        for b in inputs["batches"]:
            state, _ = step(state, b)
            got.append({p: np.asarray(v) for p, v in
                        t_tree.flatten_with_path(t_sharding.to_numpy(state))})
        out[case] = got
    return out


def test_the_bf16_gap_is_the_reference_s_own_rounding(references, reference_gap, unmeshed):
    """The reference's bf16 zamba2 train step against its own f32 step,
    both from one state: on every float leaf the port's bf16 state is
    within 2e-2 of the reference's bf16 state or no farther than BF16_K
    times the reference's own bf16 state from its f32 one, with no
    ceiling (the gap is rounding, the reference's as much as the port's),
    and each leaf `BF16_NAMED` names is more than 2e-2 / BF16_K from f32
    in the reference's own run, so the rule, not the floor, bounds it.  On `d_skip`'s m and v (sums over B·S·head_dim of
    a broadcast's cotangent) the port's bf16 lies nearer the f32 step than
    the reference's own bf16 does: XLA's CPU backend sums a bf16 cotangent
    in bf16 partial sums, the port in f32 rounded once
    (`test_the_port_sums_a_broadcast_gradient_once`)."""
    same_start = [t_tree.flatten_with_path(t_sharding.to_numpy(references[c][0]["state"]))
                  for c in ("zamba", "zamba-bf16")]
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) and pa == pb
               for (pa, a), (pb, b) in zip(*same_start))
    f32, bf16 = references["zamba"][1]["leaves"], references["zamba-bf16"][1]["leaves"]
    port = unmeshed["zamba-bf16"][-1]
    far = [(p, r, reference_gap[p]) for p, gap in reference_gap.items()
           for r in [_rel(port[p].astype(np.float32), bf16[p].astype(np.float32))]
           if r > max(TRAJ["bfloat16"], BF16_K * gap)]
    assert far == [], far
    for path in BF16_NAMED:
        assert reference_gap[path] > TRAJ["bfloat16"] / BF16_K, (path, reference_gap[path])
    for path in (".opt.m['layers']['d_skip']", ".opt.v['layers']['d_skip']"):
        to_f32 = _rel(port[path].astype(np.float32), f32[path].astype(np.float32))
        assert to_f32 < 0.5 * reference_gap[path], (path, to_f32, reference_gap[path])


def test_the_port_sums_a_broadcast_gradient_once():
    """The gradient of a bf16 scale broadcast over (B, S, ·, dh), as of
    `d_skip`: the port's is the exact sum of the bf16 products rounded
    once to bf16; the reference's (XLA on the CPU) lies farther from it."""
    rng = np.random.default_rng(0)
    dy, xh = (rng.standard_normal((4, 24, 8, 32)).astype(np.float32) for _ in range(2))
    dyb, xhb = (torch.from_numpy(a).to(torch.bfloat16) for a in (dy, xh))
    prod = (dyb.to(torch.float32) * xhb.to(torch.float32)).to(torch.bfloat16)
    exact = prod.to(torch.float64).sum((0, 1, 3)).to(torch.bfloat16).to(torch.float32).numpy()

    d = torch.ones(8, requires_grad=True)
    ((d.to(torch.bfloat16)[None, None, :, None] * xhb).to(torch.float32)
     * dyb.to(torch.float32)).sum().backward()
    np.testing.assert_array_equal(d.grad.numpy(), exact)

    jd, jx = jnp.asarray(dy).astype(jnp.bfloat16), jnp.asarray(xh).astype(jnp.bfloat16)
    loss = lambda s: ((s.astype(jnp.bfloat16)[None, None, :, None] * jx).astype(jnp.float32)
                      * jd.astype(jnp.float32)).sum()
    want = np.asarray(jax.jit(jax.grad(loss))(jnp.ones(8, jnp.float32)))
    assert np.abs(want - exact).sum() > np.abs(d.grad.numpy() - exact).sum()


@pytest.mark.parametrize("case", ["zamba", "zamba-bf16"])
def test_unmeshed_step_witnesses_the_bf16_bounds(case, references, reference_gap, unmeshed):
    """The port's own unmeshed zamba2 step from the reference's state: in
    f32 every leaf within 2e-5 of the reference's after two steps (the
    arithmetic is the reference's); in bf16 every leaf within the bounds
    the split is held to (so the leaves whose bound passes 2e-2 are as far
    without the split), and where `conv_b`'s first update (±lr by its
    gradient's sign, from zero) differs in sign from the reference's, the
    reference's gradient there is under 1e-2 of its largest: bf16 rounding
    of gradients near zero."""
    want, got = references[case][1], unmeshed[case]
    dtype = TRAIN[case][2]
    bound = ((lambda path: 2e-5) if dtype == "float32"
             else (lambda path: _bound(path, dtype, reference_gap)))
    far = [(p, r) for p, w in want["leaves"].items() if w.dtype.kind == "f"
           for r in [_rel(got[-1][p].astype(np.float32), w.astype(np.float32))] if r > bound(p)]
    assert far == [], far
    key, first = ".params['layers']['conv_b']", want["steps"][0]
    flip = np.sign(got[0][key]) != np.sign(first[key])
    g = np.abs(first[".opt.m['layers']['conv_b']"].astype(np.float32))
    assert np.all(g[flip] < 1e-2 * g.max()), g[flip] / g.max()


@pytest.mark.parametrize("mesh_id,case", SERVES)
def test_split_prefill_decode_matches_the_reference(mesh_id, case, runs, serving):
    """Prefill (the stream whole, the products split; the SSD states, conv
    inputs and WKV states gathered into the replicated cache) + 6
    teacher-forced decode steps (every product on the stored columns,
    every head against the replicated states) against the reference's
    unmeshed `api` steps: logits at 1e-4 every step on every rank, and
    every cache leaf of each rank's own block at the end."""
    want = serving[case][1]
    for r in runs[mesh_id]:
        got = r[f"serve/{case}"]
        assert len(got["logits"]) == len(want["logits"])
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
        assert set(got["blocks"]) == set(want["cache"])
        for path, (g, index) in got["blocks"].items():
            w = want["cache"][path][tuple(slice(a, a + n) for a, n in index)]
            np.testing.assert_allclose(g, w.astype(g.dtype), rtol=1e-4, atol=1e-4, err_msg=path)


@pytest.mark.parametrize("mesh_id", list(PLAN))
def test_split_steps_allocate_no_whole_matrix_and_keep_the_carry(mesh_id, runs):
    """On every rank: no tensor of a train step (forward, backward,
    recompute), prefill or decode step has the shape of a whole matrix the
    split reads in part (`_recurrent_forbidden`: nor of a whole stacked
    leaf), and no gather over "model" makes one whose shape a step also
    makes by design; each layer body starts from, and `remat` keeps,
    zamba2's (B_local, S, d / n_model) carry block or rwkv6's whole
    (B_local, S, d) stream."""
    checked = 0
    for r in runs[mesh_id]:
        for key, val in r.items():
            if key.startswith(("train/", "serve/")):
                assert val["violations"] == [], (key, val["violations"][:5])
                assert val["allocations"] > 0 and val["forbidden"] > 0, key
                checked += 1
            if key.startswith("train/"):
                assert val["remat"] == [val["remat_want"]], (key, val["remat"])
    train, serve = PLAN[mesh_id]
    assert checked == (len(train) + len(serve)) * len(runs[mesh_id])


@pytest.mark.parametrize("family", list(FLOPS))
def test_one_layer_flops_on_a_rank(family, runs):
    """One layer of zamba2 (its shared block included) or rwkv6 SMOKE, 4 ×
    32 tokens on (1, 4): each rank's matmul FLOPs (`FlopCounterMode`) at
    most 0.35 of the unmeshed layer's."""
    for r in runs["1x4"]:
        fl = r[f"flops/{family}"]
        assert fl["whole"] > 0 and fl["split"] <= 0.35 * fl["whole"], fl
