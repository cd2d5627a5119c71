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
bf16 within 2e-2, but for the leaves `BF16_NAMED` bounds, which the port's
own unmeshed step puts as far from the reference:
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
# The bf16 zamba2 leaves that the port's unmeshed step already puts farther
# from the reference than 2e-2, or at it, after two steps from the
# reference's own state; the readings, (1, 4) split / unmeshed
# (`tests/torch_bf16_gap.py`), beside each bound.  `conv_b` starts at zero,
# so AdamW's first step leaves ±lr by its gradient's sign, and bf16 flips
# the sign of gradients near zero (2 of 576, at 7e-5 and 1.3e-3 of the
# largest); the rest are gradient statistics of few-element leaves (v reads
# the squared gradient).  In f32 every leaf is within 6e-6.
BF16_NAMED = {
    ".params['layers']['conv_b']": 0.1,     # 0.0776 / 0.0793
    ".opt.v['layers']['d_skip']": 0.07,     # 0.0507 / 0.0462
    ".opt.m['layers']['d_skip']": 0.045,    # 0.0326 / 0.0311
    ".opt.v['layers']['conv_b']": 0.035,    # 0.0243 / 0.0228
    ".opt.v['layers']['a_log']": 0.03,      # 0.0213 / under 0.0138
    ".opt.m['layers']['dt_bias']": 0.03,    # 0.0199 / 0.0191
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


def _bound(path, dtype):
    return BF16_NAMED.get(path, TRAJ[dtype]) if dtype == "bfloat16" else TRAJ[dtype]


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
def test_split_train_step_matches_the_reference(mesh_id, case, runs, references):
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
            if rel > _bound(path, dtype):
                far.append((path, rel))
    assert far == [], far


@pytest.mark.parametrize("case", ["zamba", "zamba-bf16"])
def test_unmeshed_step_witnesses_the_bf16_bounds(case, references):
    """The port's own unmeshed zamba2 step from the reference's state: in
    f32 every leaf within 2e-5 of the reference's after two steps (the
    arithmetic is the reference's); in bf16 every leaf within the bounds
    the split is held to (so the leaves `BF16_NAMED` bounds are as far
    without the split), and where `conv_b`'s first update (±lr by its
    gradient's sign, from zero) differs in sign from the reference's, the
    reference's gradient there is under 1e-2 of its largest: bf16 rounding
    of gradients near zero."""
    inputs, want = references[case]
    dtype = TRAIN[case][2]
    step = t_ts.make_train_step(inputs["tcfg"], execution=Execution(device="cpu"))
    state, got = copy.deepcopy(inputs["state"]), []
    for b in inputs["batches"]:
        state, _ = step(state, b)
        got.append({p: np.asarray(v) for p, v in
                    t_tree.flatten_with_path(t_sharding.to_numpy(state))})
    bound = (lambda path: 2e-5) if dtype == "float32" else (lambda path: _bound(path, dtype))
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
