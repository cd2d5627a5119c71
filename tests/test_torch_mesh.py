"""The port's mesh path against the JAX package: the sharding rules, the
program keys, and — on gloo ranks spawned on the CPU — the meshed train
step (with grad-accumulation, with rows the DP axes do not divide, and the
MoE step expert-parallel on the stored expert shards), the RP-compressed
DP step, `dr_transform`, `DRService(mesh=)`, meshed prefill + decode over
a K/V cache split over `model` (the sliding-window ring, `kv_rp`), the
allocation guard over every meshed step, the elastic restore and the
trainer's resume.

Specs are compared exactly, as axis-name tuples, on five meshes; the
reference's rules read only `axis_names` and `devices.shape`, so a
stand-in mesh serves both packages without devices.  The multi-rank runs
are `tests/torch_mesh_ranks.py` scenarios: one spawn of 4 ranks on (2
data, 2 model) and one of 8 on (4 data, 2 model), each rank one thread, no
JAX inside a rank.  The reference's numbers are computed here: its DR
endpoint and its compressed DP step on 8 / 4 host devices in one JAX
subprocess, its expert-parallel MoE train step under `with mesh:` on (2,
2) host devices, and — because its meshed LM steps fail with
this JAX (`ShardingTypeError` at the embedding gather;
tests/test_fault_tolerance.py::TestResume,
tests/test_scheduler.py::TestStepTraffic::test_lm_prefill_decode_through_queue)
— its unmeshed LM steps, which a sharded program must equal.  Tolerances:
specs exact, DR 1e-5 / 1e-6, f32 LM logits and cache 1e-4, trajectories
(two train steps, per leaf in relative norm) 5e-4."""

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
from jax.sharding import PartitionSpec as P

from repro.configs import registry as j_registry
from repro.core import dr_unit as j_dr_unit
from repro.dist import sharding as j_sharding
from repro.dr import DRModel as JModel
from repro.dr import EASIStage as JEASI
from repro.dr import RPStage as JRP
from repro.models import api as j_api
from repro.models import transformer as j_transformer
from repro.models.config import DRFrontendSpec as JSpec
from repro.train import optimizer as j_opt
from repro.train import train_step as j_ts
from repro_torch import bridge
from repro_torch import tree as t_tree
from repro_torch.configs import registry as t_registry
from repro_torch.core.execution import Execution
from repro_torch.data import synthetic as t_synthetic
from repro_torch.dist import compress as t_compress
from repro_torch.dist import sharding as t_sharding
from repro_torch.dr import DRModel, EASIStage, RPStage
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import api as t_api
from repro_torch.models.config import DRFrontendSpec as TSpec
from repro_torch.serve import BucketPolicy, DRService, engine, registry as t_reg
from repro_torch.train import optimizer as t_opt
from repro_torch.train import train_step as t_ts
from repro_torch.train import trainer as t_trainer
from torch_lm_parity import CPU, configs, np_tree, request
from torch_mesh_ranks import spawn

ROOT = Path(__file__).resolve().parents[1]
TRAJ = 5e-4


class StandInMesh:
    """What both packages' rules read of a mesh: axis names and a shape."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


MESHES = {"1x1": ((1, 1), ("data", "model")), "2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")), "1x8": ((1, 8), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def _mesh(mesh_id):
    return StandInMesh(*MESHES[mesh_id])


def _ref_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {jax.tree_util.keystr(kp): tuple(spec) for kp, spec in flat}


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", j_registry.ARCH_IDS)
def test_param_and_cache_specs_equal_the_reference(arch, mesh_id):
    jc, tc = configs(arch)
    mesh = _mesh(mesh_id)
    jparams = jax.eval_shape(lambda: j_api.init_params(jax.random.PRNGKey(0), jc))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        tparams = t_api._mod(tc).init_params(torch.Generator(), tc, device=torch.device("cpu"))
    assert t_sharding.param_specs(tparams, mesh) == _ref_specs(
        j_sharding.param_specs(jparams, mesh))
    jcache = jax.eval_shape(lambda: j_api.init_cache(jc, 8, 32))
    tcache = t_api.init_cache(tc, 8, 32, execution=CPU)
    assert t_sharding.cache_specs(tcache, mesh) == _ref_specs(j_sharding.cache_specs(jcache, mesh))


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_batch_state_specs_and_axes_equal_the_reference(mesh_id):
    mesh = _mesh(mesh_id)
    assert t_sharding.batch_axes(mesh) == j_sharding.batch_axes(mesh)
    for axes in (None, "data", "model", "pod", ("pod", "data"), ("data", "model"), ()):
        assert t_sharding.axis_size(mesh, axes) == j_sharding.axis_size(mesh, axes)
    for rows in (8, 3):
        batch = {"tokens": np.zeros((rows, 16), np.int32),
                 "frames": np.zeros((rows, 16, 32), np.float32), "pos": np.zeros((), np.int32)}
        assert t_sharding.train_batch_specs(batch, mesh) == _ref_specs(
            j_sharding.train_batch_specs(batch, mesh))
    for arch, dr in (("smollm_135m", False), ("hubert_xlarge", True)):
        jc, tc = configs(arch)
        if dr:
            jc = dataclasses.replace(jc, dr_frontend=JSpec(p=16, n=8))
            tc = dataclasses.replace(tc, dr_frontend=TSpec(p=16, n=8))
        jstate = jax.eval_shape(lambda: j_ts.init_state(jax.random.PRNGKey(0),
                                                        j_ts.TrainConfig(arch=jc)))
        tstate = t_ts.init_state(torch.Generator().manual_seed(0), t_ts.TrainConfig(arch=tc),
                                 execution=CPU)
        assert t_ts.state_specs(tstate, mesh) == _ref_specs(j_ts.state_specs(jstate, mesh))
    # the DR model's specs: every stage replicated
    jm = JModel(stages=(JRP(32, 16), JEASI.rotation(16, 8)))
    tm = DRModel(stages=(RPStage(32, 16), EASIStage.rotation(16, 8)), execution=CPU)
    got, want = tm.shard_specs(mesh), jm.shard_specs(mesh)
    assert got.stages == tuple(tuple(s) for s in want.stages) and got.steps == tuple(want.steps)


def test_constrain_and_rules_at_their_edges():
    mesh = _mesh("4x2")
    # the reference's edge cases: indivisible dims and the stacked layer dim
    assert t_sharding.param_spec("['layers']['wq']", (30, 577, 9 * 64), mesh) == \
        tuple(j_sharding.param_spec("['layers']['wq']", (30, 577, 9 * 64), mesh))
    assert t_sharding.param_spec("['layers']['w_in']", (32, 16, 4096, 6400), mesh)[0] is None
    with t_sharding.use_mesh("m"):
        assert t_sharding.ambient_mesh() == "m" and t_sharding.kv_seq_shard() == ("m", 0, 1)
    assert t_sharding.ambient_mesh() is None


def test_meshes_refuse_what_they_cannot_build():
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs a world size of {need}; this run has "
                                             f"a world size of 1"):
            t_mesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        DRService(mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        t_ts.make_train_step(t_ts.TrainConfig(arch=t_registry.get_smoke("smollm_135m")),
                             execution=CPU, mesh=_mesh("1x1"))


def test_program_keys_hold_the_device(monkeypatch):
    """C6: one config served on two cards builds a program for each; the
    fleet's config hash still names the device type only."""
    tm = DRModel(stages=(RPStage(16, 8), EASIStage.rotation(8, 4)), execution=CPU)
    state = tm.init(torch.Generator().manual_seed(0))
    card = {"index": 0}
    monkeypatch.setattr(engine, "_device_key", lambda model: ("cuda", card["index"]))
    svc = DRService(buckets=BucketPolicy(min_bucket=8, max_bucket=8))
    svc.register("a", tm, state)
    svc.register("b", tm, state)
    x = torch.ones((5, 16))
    svc.transform("a", x)
    svc.transform("b", x)
    assert svc.cache.misses == 1            # one card: one program for the config
    card["index"] = 1
    svc.transform("b", x)
    assert svc.cache.misses == 2            # the second card builds its own
    svc.serve_and_update("a", torch.ones((8, 16)))
    card["index"] = 0
    svc.serve_and_update("a", torch.ones((8, 16)))
    assert svc.cache.misses == 4
    on = lambda dev: tm.with_execution(Execution(device=dev))
    assert t_reg.model_config_hash(on("cuda:0")) == t_reg.model_config_hash(on("cuda:1")) \
        == t_reg.model_config_hash(on("cuda"))


# ---------------------------------------------------------------------------
# the reference's side of the multi-rank runs
# ---------------------------------------------------------------------------

REF_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import registry
from repro.dist import compress
from repro.dr import DRModel, EASIStage, RPStage
from repro.serve import dr_serve
from repro.train import optimizer as opt, train_step as ts

args = pickle.load(open(sys.argv[1], "rb"))
out = {}
model = DRModel(stages=(RPStage(32, 16), EASIStage.rotation(16, 8)))
state = model.init(jax.random.PRNGKey(args["dr_key"]))
mesh = jax.make_mesh((4, 2), ("data", "model"))
for name, x in args["dr_x"].items():
    y = dr_serve.dr_transform(model, state, jnp.asarray(x), mesh=mesh)
    out["dr/" + name] = (np.asarray(y), tuple(y.sharding.spec))

jc = dataclasses.replace(registry.get_smoke("smollm_135m"), compute_dtype="float32")
cfg = ts.TrainConfig(arch=jc, opt=opt.AdamWConfig(**args["opt"]),
                     grad_compress=compress.CompressConfig(**args["compress"]))
dmesh = Mesh(np.array(jax.devices()[:4]).reshape(4, 1), ("data", "model"))
st = ts.init_state(jax.random.PRNGKey(0), cfg)
ef = jax.tree.map(jnp.zeros_like, st.params)
step = ts.make_dp_compressed_step(cfg, dmesh)
metrics = []
for b in args["dp_batches"]:
    st, ef, m = step(st, {k: jnp.asarray(v) for k, v in b.items()}, ef)
    metrics.append({k: float(v) for k, v in m.items()})
rs = {}
for i, leaf in enumerate(jax.tree.leaves(st.params)):
    if leaf.size >= cfg.grad_compress.min_size:
        c, n, p = compress._chunk_dims(leaf.size, cfg.grad_compress)
        rs[i] = np.asarray(compress._rp_matrix(
            jax.random.fold_in(jax.random.PRNGKey(cfg.grad_compress.seed), i), p, c, p),
            np.int8)
out["dp"] = {"metrics": metrics, "r": rs,
             "params": {jax.tree_util.keystr(kp): np.asarray(l)
                        for kp, l in jax.tree_util.tree_flatten_with_path(st.params)[0]},
             "ef": [{jax.tree_util.keystr(kp): np.asarray(l)
                     for kp, l in jax.tree_util.tree_flatten_with_path(ef)[0]}]}
# the expert-parallel MoE step: the loss under `with mesh:` on (2, 2), so
# moe_layer takes its shard_map branch (inputs whole: the meshed
# make_train_step fails with this JAX at the embedding gather)
emesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out["ep"] = {}
for name, case in args["ep"].items():
    jc = dataclasses.replace(registry.get_smoke(case["arch"]), compute_dtype="float32")
    cfg = ts.TrainConfig(arch=jc, opt=opt.AdamWConfig(**case["opt"]))
    loss_fn = ts.make_loss(cfg, None)

    @jax.jit
    def ep_step(state, batch):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params, state.dr,
                                                                        batch)
        params, opt_state, metrics = opt.apply_updates(state.params, grads, state.opt, cfg.opt)
        return ts.TrainState(params, opt_state, state.dr, state.step + 1), \
            {"loss": loss, **metrics, **aux}

    st = ts.init_state(jax.random.PRNGKey(0), cfg)
    metrics = []
    with emesh:
        for b in case["batches"]:
            st, m = ep_step(st, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    out["ep"][name] = {"metrics": metrics,
                       "leaves": {jax.tree_util.keystr(kp): np.asarray(l)
                                  for kp, l in jax.tree_util.tree_flatten_with_path(st)[0]}}
pickle.dump(out, open(sys.argv[2], "wb"))
print("REF_OK")
"""

DP_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
DP_COMPRESS = dict(ratio=4, chunk=1024, min_size=1024)
DR_KEY = 7


def _dr_inputs():
    rng = np.random.default_rng(5)
    return {"odd": rng.standard_normal((13, 32)).astype(np.float32),
            "even": rng.standard_normal((16, 32)).astype(np.float32)}


def _smollm_f32():
    return configs("smollm_135m", "float32")


def _dp_batches(jc):
    data = t_synthetic.TokenStreamConfig(vocab_size=jc.vocab_size, seq_len=16, global_batch=4,
                                         seed=3)
    return [{"tokens": t_synthetic.token_batch(data, i)["tokens"].numpy()} for i in range(2)]


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's DR endpoint on a (4, 2) mesh of 8 host devices, its
    compressed DP step on 4 and its expert-parallel MoE train steps on (2,
    2), in one subprocess."""
    d = tmp_path_factory.mktemp("mesh_ref")
    jc, _ = _smollm_f32()
    ep = {name: {"arch": spec["arch"], "opt": TRAIN_OPT,
                 "batches": [{k: v.numpy() for k, v in b.items()}
                             for b in _train_case(spec)[3]]}
          for name, spec in EP_TRAIN_CASES.items()}
    args = {"dr_key": DR_KEY, "dr_x": _dr_inputs(), "opt": DP_OPT, "compress": DP_COMPRESS,
            "dp_batches": _dp_batches(jc), "ep": ep}
    with open(d / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(d / "args.pkl"),
                          str(d / "out.pkl")], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and "REF_OK" in res.stdout, res.stderr[-3000:]
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f)


TRAIN_CASES = {
    "smollm": dict(arch="smollm_135m", accum=1, batch=4),
    "smollm-accum2": dict(arch="smollm_135m", accum=2, batch=8),
    "hubert-dr": dict(arch="hubert_xlarge", accum=1, batch=4, dr=True),
    # 3 rows: the DP axes divide them on neither mesh, so every rank holds
    # the whole batch (`rows_split` false) and the gradients are not summed
    "smollm-rows3": dict(arch="smollm_135m", accum=1, batch=3),
}
# On (2 data, 2 model), where the MoE layer is expert-parallel on the
# stored expert shards; held to the reference's own expert-parallel step.
EP_TRAIN_CASES = {
    "phi-moe-ep": dict(arch="phi35_moe", accum=1, batch=8),
}
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
# Run on (4 data, 1 model), where expert parallelism does not apply: the MoE
# layer must drop tokens by the whole batch's capacity.  At capacity factor 1
# (128 tokens over 4 experts, top-2) experts overflow both a rank's capacity
# and the whole batch's, so the two rules drop different tokens.
DATA_MESH_TRAIN_CASES = {
    "phi-moe": dict(arch="phi35_moe", accum=1, batch=8, capacity=1.0),
}


def _train_case(spec):
    jc, tc = configs(spec["arch"], "float32")
    if spec.get("dr"):
        jc = dataclasses.replace(jc, dr_frontend=JSpec(p=16, n=8))
        tc = dataclasses.replace(tc, dr_frontend=TSpec(p=16, n=8))
    if "capacity" in spec:
        jc, tc = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=spec["capacity"])) for c in (jc, tc))
    jcfg = j_ts.TrainConfig(arch=jc, opt=j_opt.AdamWConfig(**TRAIN_OPT),
                            grad_accum=spec["accum"])
    tcfg = t_ts.TrainConfig(arch=tc, opt=t_opt.AdamWConfig(**TRAIN_OPT),
                            grad_accum=spec["accum"])
    j_state = j_ts.init_state(jax.random.PRNGKey(0), jcfg)
    data = t_synthetic.TokenStreamConfig(vocab_size=jc.vocab_size, seq_len=16,
                                         global_batch=spec["batch"], seed=3)
    batches = [t_trainer.make_batch(tc, data, i) for i in range(2)]
    return jcfg, tcfg, j_state, batches


def _reference_step(tcfg):
    """The reference's train step body (`make_train_step`'s `step`) from its
    own parts, jitted, without a mesh (its meshed step fails with this JAX)."""
    dcfg = j_ts._dr_cfg(tcfg.arch)
    loss_fn = j_ts.make_loss(tcfg, dcfg)

    @jax.jit
    def step(state, batch):
        if tcfg.grad_accum > 1:
            def micro(carry, mb):
                (l, _), g = jax.value_and_grad(loss_fn, has_aux=True)(state.params, state.dr, mb)
                return (jax.tree.map(jnp.add, carry[0], g), carry[1] + l), None

            mbs = jax.tree.map(lambda a: a.reshape((tcfg.grad_accum, a.shape[0] // tcfg.grad_accum)
                                                   + a.shape[1:]), batch)
            zero = jax.tree.map(lambda p: jnp.zeros_like(p, jnp.float32), state.params)
            (gsum, lsum), _ = jax.lax.scan(micro, (zero, 0.0), mbs)
            grads = jax.tree.map(lambda g: g / tcfg.grad_accum, gsum)
            loss, aux = lsum / tcfg.grad_accum, {}
        else:
            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state.params, state.dr, batch)
        params, opt_state, metrics = j_opt.apply_updates(state.params, grads, state.opt,
                                                         tcfg.opt)
        dr = state.dr
        if dr is not None:
            key = "frames" if "frames" in batch else "patches"
            feats = j_ts._dr_normalize(batch[key].reshape(-1, tcfg.arch.frontend_dim))
            dr = j_dr_unit.update(dr, dcfg, feats[:4096])
        return j_ts.TrainState(params, opt_state, dr, state.step + 1), \
            {"loss": loss, **metrics, **aux}

    return step


@pytest.fixture(scope="module")
def train_refs():
    """Per case: the port's inputs and the reference's two unmeshed steps."""
    out = {}
    for name, spec in {**TRAIN_CASES, **DATA_MESH_TRAIN_CASES}.items():
        jcfg, tcfg, j_state, batches = _train_case(spec)
        t_state = bridge.train_state_from_reference(np_tree(j_state), device="cpu")
        step = _reference_step(jcfg)
        metrics = []
        for b in batches:
            j_state, m = step(j_state, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        leaves = {jax.tree_util.keystr(kp): np.asarray(l)
                  for kp, l in jax.tree_util.tree_flatten_with_path(j_state)[0]}
        out[name] = ({"tcfg": tcfg, "state": t_state, "batches": batches},
                     {"metrics": metrics, "leaves": leaves})
    return out


@pytest.fixture(scope="module")
def run_2x2(tmp_path_factory, train_refs, reference_runs):
    d = tmp_path_factory.mktemp("mesh_2x2")
    jc, tc = _smollm_f32()
    jcfg = j_ts.TrainConfig(arch=jc, opt=j_opt.AdamWConfig(**DP_OPT),
                            grad_compress=None)
    t_state = bridge.train_state_from_reference(
        np_tree(j_ts.init_state(jax.random.PRNGKey(0), jcfg)), device="cpu")
    dp_cfg = t_ts.TrainConfig(arch=tc, opt=t_opt.AdamWConfig(**DP_OPT),
                              grad_compress=t_compress.CompressConfig(**DP_COMPRESS))
    trainer_cfg = t_trainer.TrainerConfig(
        train=t_ts.TrainConfig(arch=tc, opt=t_opt.AdamWConfig(lr=1e-3), seed=0), total_steps=6,
        ckpt_dir=str(d / "unused"), ckpt_every=3, log_every=100)
    ep = {}
    for name, spec in EP_TRAIN_CASES.items():
        _, tcfg, j_state, batches = _train_case(spec)
        ep[name] = {"tcfg": tcfg, "batches": batches,
                    "state": bridge.train_state_from_reference(np_tree(j_state), device="cpu")}
    inputs = {
        "train": {n: train_refs[n][0] for n in TRAIN_CASES},
        "train_ep": ep,
        "train_data_mesh": {n: train_refs[n][0] for n in DATA_MESH_TRAIN_CASES},
        "dp": {"tcfg": dp_cfg, "state": t_state, "r": reference_runs["dp"]["r"],
               "batches": [{k: torch.from_numpy(v) for k, v in b.items()}
                           for b in _dp_batches(jc)]},
        "elastic": {"state": t_state, "dir": str(d / "ck")},
        "trainer": {"cfg": trainer_cfg,
                    "data": t_synthetic.TokenStreamConfig(vocab_size=256, seq_len=32,
                                                          global_batch=4)},
    }
    return spawn("mesh_2x2", 4, d / "ranks", inputs, timeout=300), inputs


# h2o's 20-token prompt wraps its 16-slot sliding-window ring; yi keeps
# 18 slots, 9 a rank, and its keys RP-sketched on the reference's R;
# zamba's shared block keeps its K/V slots split the same way; rwkv6 keeps
# no K/V cache (its layers are gathered from the shards all the same)
SERVE_CASES = {"h2o": ("h2o_danube3_4b", {}), "phi-moe": ("phi35_moe", {}),
               "yi-kvrp": ("yi_6b", {"kv_rp": 2}), "zamba": ("zamba2_7b", {}),
               "rwkv6": ("rwkv6_1b6", {})}


@pytest.fixture(scope="module")
def run_4x2(tmp_path_factory, train_refs, run_2x2):
    d = tmp_path_factory.mktemp("mesh_4x2")
    jm = JModel(stages=(JRP(32, 16), JEASI.rotation(16, 8)))
    tm = DRModel(stages=(RPStage(32, 16), EASIStage.rotation(16, 8)),
                 execution=Execution(backend="kernel", device="cpu"))
    t_dr = bridge.from_reference(jm.init(jax.random.PRNGKey(DR_KEY)), device="cpu")
    rng = np.random.default_rng(9)
    rows = {n: torch.from_numpy(rng.standard_normal((n, 32)).astype(np.float32))
            for n in (3, 17, 63)}
    serve = {}
    for name, (arch, changes) in SERVE_CASES.items():
        jc, tc = configs(arch, "float32", **changes)
        inputs, forced, cache_size = request(jc, batch=4)
        params = j_api.init_params(jax.random.PRNGKey(3), jc)
        serve[name] = {"cfg": tc, "params": bridge.params_from_reference(np_tree(params),
                                                                         device="cpu"),
                       "batch": {k: torch.from_numpy(v) for k, v in inputs.items()},
                       "forced": [torch.from_numpy(forced[:, i]) for i in range(forced.shape[1])],
                       "cache_size": cache_size, "ref": (jc, params, inputs, forced)}
        if jc.kv_rp:
            serve[name]["kv_rp_r"] = bridge.to_tensor(
                np.asarray(j_transformer._kv_rp_matrix(jc)), device="cpu")
    _, tc = _smollm_f32()
    target = t_ts.init_state(torch.Generator().manual_seed(9), t_ts.TrainConfig(arch=tc),
                             execution=CPU)
    inputs = {
        "dr": {"model": tm, "state": t_dr,
               "x": {k: torch.from_numpy(v) for k, v in _dr_inputs().items()}, "rows": rows},
        "train": {n: train_refs[n][0] for n in TRAIN_CASES},
        "serve": {n: {k: v for k, v in c.items() if k != "ref"} for n, c in serve.items()},
        "elastic": {"target": target, "dir": run_2x2[1]["elastic"]["dir"]},
    }
    return spawn("mesh_4x2", 8, d / "ranks", inputs, timeout=300), inputs, \
        {n: c["ref"] for n, c in serve.items()}, (jm, tm, t_dr)


# ---------------------------------------------------------------------------
# the multi-rank checks
# ---------------------------------------------------------------------------

def test_ranks_run_without_jax(run_2x2, run_4x2):
    for res in (run_2x2[0], run_4x2[0]):
        assert not any(r["jax_loaded"] for r in res)


@pytest.mark.parametrize("mesh", ["2x2", "4x2"])
@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_meshed_train_step_matches_the_reference(case, mesh, run_2x2, run_4x2, train_refs):
    """Two steps of `make_train_step(mesh=)` from the reference's initial
    state against two unmeshed reference steps: loss, grad_norm, lr and the
    aux terms at rtol 1e-5 each step (the same on every rank), then every
    leaf of the state (params, AdamW m / v, the DR unit's B) within 5e-4
    in relative norm; integers exactly."""
    _check_train(case, (run_2x2 if mesh == "2x2" else run_4x2)[0], train_refs[case][1])


@pytest.mark.parametrize("case", list(EP_TRAIN_CASES))
def test_expert_parallel_train_step_matches_the_reference(case, run_2x2, reference_runs):
    """Two steps of phi3.5-moe SMOKE through `make_train_step(mesh=)` on (2
    data, 2 model), each layer's experts taken from the stored shards
    (gathered over `data`, then one all-to-all over `model` from the
    feature split to the expert split), against two of the reference's
    expert-parallel steps (its `shard_map` branch under `with mesh:` on
    (2, 2) host devices; each slice's capacity and the aux terms' pmean are
    the reference's), held as above."""
    _check_train(case, run_2x2[0], reference_runs["ep"][case])


@pytest.mark.parametrize("case", list(DATA_MESH_TRAIN_CASES))
def test_meshed_moe_train_step_on_a_data_mesh_matches_the_reference(case, run_2x2, train_refs):
    """Two steps of phi3.5-moe SMOKE through `make_train_step(mesh=)` on (4
    data, 1 model), where the MoE layer is not expert-parallel and gathers
    the DP rows to dispatch by the whole batch's capacity, against two
    unmeshed reference steps, held as above."""
    _check_train(case, run_2x2[0], train_refs[case][1])


def _check_train(case, res, want):
    for r in res:
        got = r[f"train/{case}"]
        for i, (gm, wm) in enumerate(zip(got["metrics"], want["metrics"])):
            assert set(gm) == set(wm)
            for name in wm:
                np.testing.assert_allclose(gm[name], wm[name], rtol=1e-5, atol=1e-6,
                                           err_msg=f"{name} at step {i}")
    got = res[0][f"train/{case}"]["leaves"]
    assert set(got) == set(want["leaves"])
    for path, w in want["leaves"].items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            assert _rel(g, w) <= TRAJ, path


def test_local_shards_have_their_spec_shapes(run_2x2, run_4x2):
    for res in (run_2x2[0], run_4x2[0]):
        for r in res:
            for key, val in r.items():
                if key.startswith("train/") or key.startswith("serve/"):
                    assert val["shapes"], key
                    for path, (local, want) in val["shapes"].items():
                        assert local == want, (key, path)
    # the FSDP layout really splits: smollm's embedding (V, d) on (4, 2)
    emb = run_4x2[0][0]["train/smollm"]["shapes"][".params['embed']"]
    assert emb[0][0] * 4 == run_4x2[1]["train"]["smollm"]["state"].params["embed"].shape[0]


def test_dp_compressed_step_matches_the_reference(run_2x2, reference_runs):
    """`make_dp_compressed_step` on 4 ranks with the reference's R against
    the reference's own step on 4 host devices: loss and grad_norm each
    step, the params after two steps, and each rank's error feedback (the
    reference returns rank 0's as the replicated value)."""
    want = reference_runs["dp"]
    for r in run_2x2[0]:
        for gm, wm in zip(r["dp"]["metrics"], want["metrics"]):
            for name in wm:
                np.testing.assert_allclose(gm[name], wm[name], rtol=1e-5, atol=1e-6,
                                           err_msg=name)
    got = run_2x2[0][0]["dp"]["params"]
    for path, w in want["params"].items():
        assert _rel(got[f"{path}"], w) <= TRAJ, path
    for path, w in want["ef"][0].items():
        assert _rel(run_2x2[0][0]["dp"]["ef"][path], w) <= TRAJ, path


def test_dp_compressed_sync_keeps_what_it_does_not_send(run_2x2):
    """Per rank and compressed leaf: synced + new error feedback = gradient
    + old error feedback (1e-6 relative), and the ranks' carries differ
    (each keeps its own residual)."""
    for r in run_2x2[0]:
        assert r["dp"]["ident"] <= 1e-6
    a, b = run_2x2[0][0]["dp"]["ef"], run_2x2[0][1]["dp"]["ef"]
    assert any(not np.array_equal(a[p], b[p]) for p in a)


@pytest.mark.parametrize("name", ["odd", "even"])
def test_dr_transform_matches_the_reference(name, run_4x2, reference_runs):
    """`dr_transform` on (4, 2): 13 rows stay replicated, 16 split over the
    4 data ranks (4 local rows each), as the reference's layout."""
    want_y, want_spec = reference_runs[f"dr/{name}"]
    for r in run_4x2[0]:
        got = r[f"dr/{name}"]
        np.testing.assert_allclose(got["y"], want_y, rtol=1e-5, atol=1e-6)
        assert got["spec"] == tuple(want_spec) + (None,) * (2 - len(want_spec))
        assert got["local"] == ((4, 8) if name == "even" else (13, 8))


def test_dr_service_answers_ragged_rows_on_a_mesh(run_4x2):
    """The twin of tests/test_serve_engine.py::
    test_ragged_batch_multidevice_subprocess, which fails in the
    reference at the engine's row slice of a sharded answer
    (src/repro/serve/engine.py:683): rows 3, 17 and 63 through
    `DRService(mesh=(4, 2))` equal `model.transform`, with 3 builds (the 8,
    32 and 64 buckets)."""
    _, tm, t_dr = run_4x2[3]
    rows = run_4x2[1]["dr"]["rows"]
    for r in run_4x2[0]:
        assert r["service"]["misses"] == 3
        for n, x in rows.items():
            np.testing.assert_allclose(r["service"]["answers"][n],
                                       tm.transform(t_dr, x).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_meshed_prefill_decode_matches_the_reference(name, run_4x2):
    """h2o, phi3.5-moe, yi with `kv_rp` = 2, zamba2 and rwkv6 SMOKE (f32) on
    (4, 2) — batch
    over data, the K/V cache's slots over model (prefill writes each rank's
    slot range, decode writes on the slot's owner and merges the ranks'
    attention through the log-sum-exp), phi's experts over model through
    the all-to-alls — prefill + 6 teacher-forced decode steps against the
    reference's unmeshed `api` steps (its meshed ones fail with this JAX):
    logits at 1e-4 every step, every cache leaf at the end."""
    jc, params, inputs, forced = run_4x2[2][name]
    jb = {k: jnp.asarray(v) for k, v in inputs.items()}
    cache_size = run_4x2[1]["serve"][name]["cache_size"]
    logits, cache = jax.jit(lambda p, b: j_api.prefill(p, b, jc, cache_size))(params, jb)
    want = [np.asarray(logits)]
    dec = jax.jit(lambda p, t, c: j_api.decode_step(p, t, c, jc))
    for i in range(forced.shape[1]):
        logits, cache = dec(params, jnp.asarray(forced[:, i]), cache)
        want.append(np.asarray(logits))
    for r in run_4x2[0]:
        got = r[f"serve/{name}"]
        assert len(got["logits"]) == len(want)
        for i, (g, w) in enumerate(zip(got["logits"], want)):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
        if jc.family != "rwkv6":          # rwkv6's decode state holds no K/V cache
            assert got["specs"]["k"] == (None, "data", "model", None, None)
    for path, w in ((jax.tree_util.keystr(kp), np.asarray(l)) for kp, l in
                    jax.tree_util.tree_flatten_with_path(cache)[0]):
        g = run_4x2[0][0][f"serve/{name}"]["cache"][path]
        np.testing.assert_allclose(g, w.astype(g.dtype), rtol=1e-4, atol=1e-4, err_msg=path)


def test_meshed_steps_allocate_no_whole_layer_expert_stack_or_cache(run_2x2, run_4x2):
    """The allocation guard: on every rank of (2, 2), (4, 1) and (4, 2), no
    tensor that a meshed train step (two steps, forward, backward and the
    recompute), prefill or decode step makes has the shape of a whole
    stacked `layers` matrix the mesh splits, of a layer's whole (E, d, f)
    expert stack, or of a K/V cache leaf whole in its slots."""
    checked = set()
    for res in (run_2x2[0], run_4x2[0]):
        for r in res:
            for key, val in r.items():
                if key.startswith(("train/", "serve/")):
                    assert val["violations"] == [], (key, val["violations"][:5])
                    assert val["allocations"] > 0 and val["forbidden"] > 0, key
                    checked.add(key)
    assert {f"train/{c}" for c in {**TRAIN_CASES, **EP_TRAIN_CASES, **DATA_MESH_TRAIN_CASES}} \
        | {f"serve/{c}" for c in SERVE_CASES} <= checked


def test_elastic_restore_across_rank_counts(run_2x2, run_4x2):
    """The twin of tests/test_fault_tolerance.py::
    test_elastic_restore_across_device_counts: a state saved laid out over
    4 ranks (2, 2) restores laid out over 8 (4, 2), every leaf equal to
    the saved one and each local shard the shape its spec gives on the new
    mesh."""
    saved = run_2x2[1]["elastic"]["state"]
    want = {p: np.asarray(bridge.to_array(v) if isinstance(v, torch.Tensor) else v)
            for p, v in t_tree.flatten_with_path(saved)}
    assert run_2x2[0][0]["elastic_saved_shapes"][".params['embed']"][0][0] * 2 == \
        saved.params["embed"].shape[0]
    for r in run_4x2[0]:
        got = r["elastic"]
        assert got["step"] == 1
        for path, w in want.items():
            np.testing.assert_array_equal(got["leaves"][path], w, err_msg=path)
        emb_local, emb_want = got["shapes"][".params['embed']"]
        assert emb_local == emb_want and emb_local[0] * 4 == saved.params["embed"].shape[0]


def test_trainer_resumes_on_a_mesh(run_2x2):
    """The twin of tests/test_fault_tolerance.py::TestResume (both of its
    cases fail in the reference on its smoke mesh): on (2, 2), 3 steps then
    a restart to 6 equal the straight 6-step run — losses and params bit
    for bit — and 12 steps bring the loss down."""
    for r in run_2x2[0]:
        t = r["trainer"]
        assert t["start"] == 3
        assert t["first"] + t["resumed"] == t["full"]
        for path, w in t["full_params"].items():
            np.testing.assert_array_equal(t["resumed_params"][path], w, err_msg=path)
        assert np.mean(t["long"][-3:]) < np.mean(t["long"][:3])


# ---------------------------------------------------------------------------
# the examples' twins, on a one-rank gloo mesh
# ---------------------------------------------------------------------------

@pytest.fixture
def own_group():
    """Ends the process group the test's `make_smoke_mesh()` started, so a
    later test in this process (the dry run's fake group) finds none."""
    import torch.distributed as dist

    was_up = dist.is_initialized()
    yield
    if dist.is_initialized() and not was_up:
        dist.destroy_process_group()


def test_serve_lm_experiment_on_the_cpu(capsys, own_group):
    """The twin of examples/serve_lm.py: DR traffic and LM steps through
    one scheduler, the LM on `make_smoke_mesh()`, fleet-wide promotes and a
    failover."""
    from repro_torch.experiments import serve_lm

    res = serve_lm.main(["--tokens", "3", "--batch", "2", "--device", "cpu"])
    assert tuple(res["generated"].shape) == (2, 3)
    assert set(res["final"].values()) == {2}
    assert "mesh={'data': 1, 'model': 1}" in capsys.readouterr().out


def test_lm_dr_frontend_experiment_on_the_cpu(capsys, own_group):
    """The twin of examples/lm_dr_frontend.py: hubert SMOKE trained on
    `make_smoke_mesh()`, with and without the RP→EASI front-end."""
    from repro_torch.experiments import lm_dr_frontend

    base, with_dr = lm_dr_frontend.main(["--steps", "3", "--device", "cpu"])
    assert len(base) == len(with_dr) == 3 and all(np.isfinite(base + with_dr))
    assert "DR whiteness KL" in capsys.readouterr().out
