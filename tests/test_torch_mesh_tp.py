"""The port's transformer split over `model` as the reference pins it, on
gloo ranks spawned on the CPU: the residual stream by sequence between
layers and through the norms, the dense products and attention heads
tensor-parallel, and a MoE layer's dispatch on the token-split stream.

Meshes (1, 4), (2, 2) and (2, 2, 2) with `pod`, one spawn of
`tests/torch_mesh_ranks.py`'s `mesh_tp` scenario each.  The configs are
SMOKE ones (with `DIMS`, so the allocation guard's shapes stay apart): h2o
(the sliding-window ring; 4 query heads over 1 K/V head, so every rank reads
the one K/V head), yi (serving with `kv_rp` on the reference's R),
phi3.5-moe (expert-parallel on the token-split stream), hubert with its DR
front-end (non-causal, audio frames), internvl2 (2 query heads: on 4 ranks
they do not divide, so its attention splits the query rows over the gathered
K/V — the degrade path — and on 2 they do), phi3.5-moe with 6 experts on 4
ranks (no expert parallelism: the tokens gathered, every expert on each
rank's feature columns; at 26 tokens too, which 4 ranks do not divide, so
every rank of `model` repeats one loss), h2o at 26 tokens (the stream stays
whole, the products split). A train step is held to the
reference's unmeshed step — loss, grad_norm, lr and the aux terms at rtol
1e-5 each step, every state leaf after two steps within 5e-4 in relative
norm (2e-2 in bf16) — except phi3.5-moe's, held to the reference's own
expert-parallel step on host devices of the same mesh (its per-slice
capacity and the aux terms' pmean are the reference's); the reference's
meshed LM steps fail with this JAX (ROADMAP C7).  Serving: prefill + 6
teacher-forced decode steps against the reference's unmeshed `api` steps,
logits at 1e-4 every step and every cache leaf at the end (h2o also with a
prompt the ranks do not divide, so its stream stays whole while its products
split).  On every rank the allocation guard finds no whole layer matrix that
the split reads in part, the residual each layer keeps for the backward is
the rank's (B_local, S/n_model, d) block (the whole stream where S does not
split), and nothing outside the layer bodies saves the whole stream; on
(1, 4) one h2o layer's matmul FLOPs on a rank are at most 0.35 of the unmeshed
layer's (0.25 ideal: its one K/V head is computed on every rank)."""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models import api as j_api
from repro.models import transformer as j_transformer
from repro.models.config import DRFrontendSpec as JSpec
from repro.train import optimizer as j_opt
from repro.train import train_step as j_ts
from repro_torch import bridge
from repro_torch.data import synthetic as t_synthetic
from repro_torch.models.config import DRFrontendSpec as TSpec
from repro_torch.train import optimizer as t_opt
from repro_torch.train import train_step as t_ts
from repro_torch.train import trainer as t_trainer
from test_torch_mesh import _reference_step
from torch_lm_parity import configs, np_tree, request
from torch_mesh_ranks import spawn

ROOT = Path(__file__).resolve().parents[1]
TRAJ = {"float32": 5e-4, "bfloat16": 2e-2}
METRIC_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)

MESHES = {"1x4": ((1, 4), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}

# The allocation guard tells a whole layer matrix by its shape, so the
# cases keep the activations' and the head's shapes off those: a
# vocabulary of 768 (no block of the head is d × d or d × d_ff), d_ff 160
# (a row block of w_out is not d × d on 2 ranks) and 24 positions
# (B_local·S is not d or d_ff).
DIMS = {"vocab_size": 768, "d_ff": 160}
# name -> (arch, seq, compute dtype, DR front-end); h2o's 24 tokens pass its
# 16-token window, internvl2's 16 follow 8 patches, phi3.5-moe's 56 keep its
# dispatch buffer (E × capacity, d) off d × d
TRAIN = {
    "h2o": ("h2o_danube3_4b", 24, "float32", False),
    "h2o-bf16": ("h2o_danube3_4b", 24, "bfloat16", False),
    "yi": ("yi_6b", 24, "float32", False),
    "phi-moe-ep": ("phi35_moe", 56, "float32", False),
    "hubert-dr": ("hubert_xlarge", 24, "float32", True),
    "internvl2": ("internvl2_1b", 16, "float32", False),
    "phi-moe-e6": ("phi35_moe", 24, "float32", False),
    "phi-moe-e6-odd": ("phi35_moe", 26, "float32", False),
    "h2o-odd": ("h2o_danube3_4b", 26, "float32", False),
}
# 6 experts do not split over 4 ranks: the layer gathers the stream's
# tokens, dispatches them by the whole batch's capacity as the reference's
# unsplit program does, and each rank computes its columns of every expert
EXPERTS = {"phi-moe-e6": 6, "phi-moe-e6-odd": 6}
# phi3.5-moe's prefill is expert-parallel, each rank dispatching its slice
# of the prompt with the slice's capacity (the reference's rule); at
# capacity factor 2 no expert overflows a slice's 16 slots, so the split
# prefill computes what the reference's unmeshed one does
SERVE = {"h2o": ("h2o_danube3_4b", {}, None), "h2o-odd": ("h2o_danube3_4b", {}, 21),
         "yi-kvrp": ("yi_6b", {"kv_rp": 2}, None), "phi-moe": ("phi35_moe", {}, None),
         "internvl2": ("internvl2_1b", {}, None)}
SERVE_CAPACITY = {"phi-moe": 2.0}
PLAN = {
    "1x4": (["h2o", "h2o-bf16", "yi", "phi-moe-ep", "hubert-dr", "internvl2", "phi-moe-e6",
             "phi-moe-e6-odd", "h2o-odd"],
            ["h2o", "h2o-odd", "yi-kvrp", "phi-moe", "internvl2"]),
    "2x2": (["h2o", "phi-moe-ep", "hubert-dr", "internvl2"],
            ["h2o", "yi-kvrp", "phi-moe", "internvl2"]),
    "2x2x2": (["h2o", "yi", "phi-moe-ep", "internvl2"], ["h2o", "phi-moe"]),
}
EP = "phi-moe-ep"


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _train_case(name):
    arch, seq, dtype, dr = TRAIN[name]
    jc, tc = configs(arch, dtype, **DIMS)
    if name in EXPERTS:
        jc, tc = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, n_experts=EXPERTS[name]))
                  for c in (jc, tc))
    if dr:
        jc = dataclasses.replace(jc, dr_frontend=JSpec(p=16, n=8))
        tc = dataclasses.replace(tc, dr_frontend=TSpec(p=16, n=8))
    jcfg = j_ts.TrainConfig(arch=jc, opt=j_opt.AdamWConfig(**TRAIN_OPT))
    tcfg = t_ts.TrainConfig(arch=tc, opt=t_opt.AdamWConfig(**TRAIN_OPT))
    j_state = j_ts.init_state(jax.random.PRNGKey(0), jcfg)
    data = t_synthetic.TokenStreamConfig(vocab_size=jc.vocab_size, seq_len=seq, global_batch=4,
                                         seed=3)
    batches = [t_trainer.make_batch(tc, data, i) for i in range(2)]
    return jcfg, tcfg, j_state, batches


def _leaves(tree):
    return {jax.tree_util.keystr(kp): np.asarray(l)
            for kp, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


EP_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import registry
from repro.train import optimizer as opt, train_step as ts

args = pickle.load(open(sys.argv[1], "rb"))
jc = dataclasses.replace(registry.get_smoke("phi35_moe"), compute_dtype="float32",
                         **args["dims"])
cfg = ts.TrainConfig(arch=jc, opt=opt.AdamWConfig(**args["opt"]))
loss_fn = ts.make_loss(cfg, None)


@jax.jit
def ep_step(state, batch):
    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params, state.dr, batch)
    params, opt_state, metrics = opt.apply_updates(state.params, grads, state.opt, cfg.opt)
    return ts.TrainState(params, opt_state, state.dr, state.step + 1), \
        {"loss": loss, **metrics, **aux}


out = {}
for mesh_id, (shape, names) in args["meshes"].items():
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)
    st = ts.init_state(jax.random.PRNGKey(0), cfg)
    metrics = []
    with mesh:
        for b in args["batches"]:
            st, m = ep_step(st, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    out[mesh_id] = {"metrics": metrics,
                    "leaves": {jax.tree_util.keystr(kp): np.asarray(l)
                               for kp, l in jax.tree_util.tree_flatten_with_path(st)[0]}}
pickle.dump(out, open(sys.argv[2], "wb"))
print("REF_OK")
"""


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """Per train case: the port's inputs and the reference's two steps —
    unmeshed, or for phi3.5-moe its expert-parallel step on each mesh (one
    JAX subprocess with 8 host devices, run while this process computes
    the unmeshed ones)."""
    d = tmp_path_factory.mktemp("mesh_tp_ref")
    ep_batches = _train_case(EP)[3]
    args = {"opt": TRAIN_OPT, "dims": DIMS,
            "meshes": {m: MESHES[m] for m in PLAN if EP in PLAN[m][0]},
            "batches": [{k: v.numpy() for k, v in b.items()} for b in ep_batches]}
    with open(d / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", EP_SCRIPT, str(d / "args.pkl"),
                             str(d / "out.pkl")], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        out = {}
        for name in TRAIN:
            jcfg, tcfg, j_state, batches = _train_case(name)
            inputs = {"tcfg": tcfg, "batches": batches,
                      "state": bridge.train_state_from_reference(np_tree(j_state), device="cpu")}
            if name == EP:
                out[name] = (inputs, None)
                continue
            step = _reference_step(jcfg)
            metrics = []
            for b in batches:
                j_state, m = step(j_state, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
                metrics.append({k: float(v) for k, v in m.items()})
            out[name] = (inputs, {"metrics": metrics, "leaves": _leaves(j_state)})
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0 and "REF_OK" in stdout, stderr[-3000:]
    with open(d / "out.pkl", "rb") as f:
        ep = pickle.load(f)
    out[EP] = (out[EP][0], ep)
    return out


@pytest.fixture(scope="module")
def serve_inputs():
    out = {}
    for name, (arch, changes, prompt) in SERVE.items():
        jc, tc = configs(arch, "float32", **DIMS, **changes)
        if name in SERVE_CAPACITY:
            jc, tc = (dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=SERVE_CAPACITY[name])) for c in (jc, tc))
        inputs, forced, cache_size = request(jc, batch=4, prompt=prompt)
        params = j_api.init_params(jax.random.PRNGKey(3), jc)
        case = {"cfg": tc, "params": bridge.params_from_reference(np_tree(params), device="cpu"),
                "batch": {k: torch.from_numpy(v) for k, v in inputs.items()},
                "forced": [torch.from_numpy(forced[:, i]) for i in range(forced.shape[1])],
                "cache_size": cache_size}
        if jc.kv_rp:
            case["kv_rp_r"] = bridge.to_tensor(np.asarray(j_transformer._kv_rp_matrix(jc)),
                                               device="cpu")
        out[name] = (case, (jc, params, inputs, forced, cache_size))
    return out


def _flops_case():
    jc, tc = configs("h2o_danube3_4b", "float32", n_layers=1)
    params = j_api.init_params(jax.random.PRNGKey(1), jc)
    tokens = np.random.default_rng(2).integers(0, jc.vocab_size, (4, 32), dtype=np.int32)
    return {"cfg": tc, "params": bridge.params_from_reference(np_tree(params), device="cpu"),
            "batch": {"tokens": torch.from_numpy(tokens)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, references, serve_inputs):
    """Every rank's results on each mesh, with the inputs they were given."""
    out = {}
    for mesh_id, (train, serve) in PLAN.items():
        inputs = {"mesh": MESHES[mesh_id],
                  "train": {n: references[n][0] for n in train},
                  "serve": {n: serve_inputs[n][0] for n in serve}}
        if mesh_id == "1x4":
            inputs["flops"] = _flops_case()
        world = int(np.prod(MESHES[mesh_id][0]))
        d = tmp_path_factory.mktemp(f"mesh_tp_{mesh_id}")
        out[mesh_id] = spawn("mesh_tp", world, d / "ranks", inputs, timeout=300)
    return out


CASES = [(m, n) for m, (train, _) in PLAN.items() for n in train]
SERVES = [(m, n) for m, (_, serve) in PLAN.items() for n in serve]


def test_ranks_run_without_jax(runs):
    assert not any(r["jax_loaded"] for res in runs.values() for r in res)


@pytest.mark.parametrize("mesh_id,case", CASES)
def test_split_train_step_matches_the_reference(mesh_id, case, runs, references):
    """Two split train steps from the reference's initial state against two
    of the reference's steps (unmeshed; phi3.5-moe's expert-parallel on the
    same mesh): the metrics on every rank each step, then every state
    leaf."""
    want = references[case][1]
    if case == EP:
        want = want[mesh_id]
    dtype = TRAIN[case][2]
    res = runs[mesh_id]
    for r in res:
        got = r[f"train/{case}"]
        for i, (gm, wm) in enumerate(zip(got["metrics"], want["metrics"])):
            assert set(gm) == set(wm)
            for name in wm:
                np.testing.assert_allclose(gm[name], wm[name], rtol=METRIC_RTOL[dtype], atol=1e-6,
                                           err_msg=f"{name} at step {i}")
    got = res[0][f"train/{case}"]["leaves"]
    assert set(got) == set(want["leaves"])
    for path, w in want["leaves"].items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            assert _rel(g.astype(np.float32), w.astype(np.float32)) <= TRAJ[dtype], path
    for r in res:
        for path, (local, spec_shape) in r[f"train/{case}"]["shapes"].items():
            assert local == spec_shape, path


@pytest.mark.parametrize("mesh_id,case", SERVES)
def test_split_prefill_decode_matches_the_reference(mesh_id, case, runs, serve_inputs):
    """Prefill (its stream split by sequence where the ranks divide the
    prompt, whole for h2o-odd's 21 tokens) + 6 teacher-forced decode steps
    (the stream whole, the products split) against the reference's
    unmeshed `api` steps: logits at 1e-4 every step on every rank, every
    cache leaf at the end."""
    jc, params, inputs, forced, cache_size = serve_inputs[case][1]
    jb = {k: jnp.asarray(v) for k, v in inputs.items()}
    logits, cache = jax.jit(lambda p, b: j_api.prefill(p, b, jc, cache_size))(params, jb)
    want = [np.asarray(logits)]
    dec = jax.jit(lambda p, t, c: j_api.decode_step(p, t, c, jc))
    for i in range(forced.shape[1]):
        logits, cache = dec(params, jnp.asarray(forced[:, i]), cache)
        want.append(np.asarray(logits))
    for r in runs[mesh_id]:
        got = r[f"serve/{case}"]
        assert len(got["logits"]) == len(want)
        for i, (g, w) in enumerate(zip(got["logits"], want)):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
    for path, w in _leaves(cache).items():
        g = runs[mesh_id][0][f"serve/{case}"]["cache"][path]
        np.testing.assert_allclose(g, w.astype(g.dtype), rtol=1e-4, atol=1e-4, err_msg=path)


@pytest.mark.parametrize("mesh_id", list(PLAN))
def test_split_steps_allocate_no_whole_layer_and_keep_the_rank_block(mesh_id, runs):
    """On every rank: no tensor of a train step (forward, backward,
    recompute), prefill or decode step has the shape of a layer matrix the
    split reads in part, whole (nor of a whole stacked leaf, expert stack
    or K/V cache leaf); each layer body starts from, and `remat` keeps,
    the rank's (B_local, S/n_model, d) block of the stream; autograd saves
    no whole stream outside the layer bodies.  A whole leaf whose shape a
    step also makes by design (`wk` / `wv` where a rank holds as many
    query heads as there are K/V heads) is held instead by the record of
    what was gathered over "model" (`ModelGathers`): no such gather makes
    its shape."""
    checked = 0
    for r in runs[mesh_id]:
        for key, val in r.items():
            if key.startswith(("train/", "serve/")):
                assert val["violations"] == [], (key, val["violations"][:5])
                assert val["allocations"] > 0 and val["forbidden"] > 0, key
                checked += 1
            if key.startswith("train/"):
                assert val["remat"] == [val["remat_want"]], (key, val["remat"])
                assert val["saved_whole"] in (0, None), key
    train, serve = PLAN[mesh_id]
    assert checked == (len(train) + len(serve)) * len(runs[mesh_id])


def test_one_layer_flops_on_a_rank(runs):
    """h2o SMOKE, one layer, 4 × 32 tokens on (1, 4): each rank's matmul
    FLOPs (`FlopCounterMode`) at most 0.35 of the unmeshed layer's."""
    for r in runs["1x4"]:
        fl = r["flops"]
        assert fl["whole"] > 0 and fl["split"] <= 0.35 * fl["whole"], fl
