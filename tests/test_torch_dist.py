"""The port's distribution layer on 8 gloo ranks against the JAX package's
8-device runs: expert-parallel MoE (`blocks.moe_layer` on a rank's stored
shards of the expert stacks over a (2 data, 4 model) mesh, two all-to-alls
over `model`) and `compress.compress_sync`
(the RP-sketched gradient sync over (8 data,)).

The reference runs its own tests' programs (tests/test_dist.py:60-104 and
:107-147) on 8 host devices in one JAX subprocess; the port's ranks are
one spawn of `tests/torch_mesh_ranks.py`'s `dist_8` scenario, one thread
each, no JAX inside a rank.  Tolerances as the reference's tests: MoE rtol
2e-4 / atol 2e-5, the synced gradient 1e-5 / 1e-6, the error feedback
1e-4 / 1e-5."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.dist import compress
from repro_torch.models import blocks
from repro_torch.models.config import MoESpec
from torch_mesh_ranks import spawn

ROOT = Path(__file__).resolve().parents[1]

REF_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.dist import compress
from repro.models import blocks
from repro.models.config import MoESpec

out = {}
d, e, f, t, k = 16, 4, 32, 128, 2
spec = MoESpec(n_experts=e, top_k=k, d_ff_expert=f, capacity_factor=float(e))
ks = jax.random.split(jax.random.PRNGKey(0), 5)
params = {
    "router": jax.random.normal(ks[0], (d, e), jnp.float32) * 0.1,
    "w_in": jax.random.normal(ks[1], (e, d, f), jnp.float32) / np.sqrt(d),
    "w_gate": jax.random.normal(ks[2], (e, d, f), jnp.float32) / np.sqrt(d),
    "w_out": jax.random.normal(ks[3], (e, f, d), jnp.float32) / np.sqrt(f),
}
x = jax.random.normal(ks[4], (2, t // 2, d), jnp.float32)
y_ref, aux_ref = blocks.moe_layer(params, x, spec, "silu")
mesh = jax.make_mesh((2, 4), ("data", "model"))
xs = jax.device_put(x, NamedSharding(mesh, P("data", "model", None)))
ps = jax.tree.map(lambda a: jax.device_put(a, NamedSharding(mesh, P())), params)
with mesh:
    y_sh, aux_sh = jax.jit(lambda p, xx: blocks.moe_layer(p, xx, spec, "silu"))(ps, xs)
out["moe"] = {"params": {n: np.asarray(v) for n, v in params.items()}, "x": np.asarray(x),
              "y_ref": np.asarray(y_ref), "y_sh": np.asarray(y_sh),
              "aux_sh": {n: float(v) for n, v in aux_sh.items()}}

cmesh = jax.make_mesh((8,), ("data",))
cfg = compress.CompressConfig(ratio=4, chunk=1024, min_size=0)
g_local = jax.random.normal(jax.random.PRNGKey(0), (8, 4096), jnp.float32)

def sync(g, ef):
    o, ef2 = compress.compress_sync({"g": g}, {"g": ef}, cfg, ("data",))
    return o["g"], ef2["g"]

fn = jax.jit(jax.shard_map(sync, mesh=cmesh, in_specs=(P("data"), P("data")),
                           out_specs=(P("data"), P("data")), check_vma=False))
g_in = g_local.reshape(8, 1, 4096)
synced, ef = fn(g_in, jnp.zeros_like(g_in))
c, n, p = compress._chunk_dims(4096, cfg)
r = compress._rp_matrix(jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 0), p, c, p)
out["compress"] = {"g": np.asarray(g_local), "synced": np.asarray(synced),
                   "ef": np.asarray(ef), "r": np.asarray(r, np.int8)}
pickle.dump(out, open(sys.argv[1], "wb"))
print("REF_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_ref")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(d / "out.pkl")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "REF_OK" in res.stdout, res.stderr[-3000:]
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f)


SPEC = MoESpec(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=4.0)


def _moe_inputs(reference):
    m = reference["moe"]
    params = {n: torch.from_numpy(v) for n, v in m["params"].items()}
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(m["x"].shape)
                         .astype(np.float32))
    return params, torch.from_numpy(m["x"]), w


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    params, x, w = _moe_inputs(reference)
    cs = reference["compress"]
    inputs = {"moe": {"params": params, "x": x, "spec": SPEC, "w": w},
              "compress": {"g": torch.from_numpy(cs["g"]), "r": cs["r"],
                           "cfg": compress.CompressConfig(ratio=4, chunk=1024, min_size=0)}}
    return spawn("dist_8", 8, tmp_path_factory.mktemp("dist_8"), inputs, timeout=240)


def test_ranks_run_without_jax(ranks):
    assert not any(r["jax_loaded"] for r in ranks)


def test_moe_expert_parallel_matches_the_reference(ranks, reference):
    """Each rank's rows of the a2a expert-parallel output equal the
    reference's 8-device `shard_map` output and its single-device output
    (capacity high enough that no path drops a token); the aux terms are
    the reference's pmean over every rank."""
    m = reference["moe"]
    np.testing.assert_allclose(m["y_sh"], m["y_ref"], rtol=2e-4, atol=2e-5)
    for r in ranks:
        di = r["moe"]["data"]
        got = r["moe"]["y"]
        np.testing.assert_allclose(got, m["y_sh"][di:di + 1], rtol=2e-4, atol=2e-5)
        for name, want in m["aux_sh"].items():
            np.testing.assert_allclose(r["moe"]["aux"][name], want, rtol=2e-4, atol=2e-5)


def test_moe_expert_parallel_allocates_no_whole_expert_stack(ranks):
    """Each rank runs the layer on its stored shards of the expert stacks:
    no op makes a tensor of a whole (E, d, f) or (E, f, d) stack."""
    assert [r["moe"]["whole_stacks"] for r in ranks] == [[]] * len(ranks)


def test_moe_expert_parallel_matches_the_single_device_layer(ranks, reference):
    params, x, _ = _moe_inputs(reference)
    y, _ = blocks.moe_layer(params, x, SPEC, "silu")
    for r in ranks:
        di = r["moe"]["data"]
        np.testing.assert_allclose(r["moe"]["y"], y[di:di + 1].numpy(), rtol=2e-4, atol=2e-5)


def test_moe_expert_parallel_gradients(ranks, reference):
    """Gradients through the all-to-alls: of Σ⟨y, w⟩ with respect to x (each
    rank's rows) and to every weight (summed over the data ranks) equal the
    single-device layer's."""
    params, x, w = _moe_inputs(reference)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xg = x.clone().requires_grad_(True)
    y, _ = blocks.moe_layer(p, xg, SPEC, "silu")
    (y * w).sum().backward()
    for r in ranks:
        di = r["moe"]["data"]
        np.testing.assert_allclose(r["moe_grad"]["x"], xg.grad[di:di + 1].numpy(),
                                   rtol=2e-4, atol=2e-5)
        for name, g in r["moe_grad"]["params"].items():
            np.testing.assert_allclose(g, p[name].grad.numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=name)


def test_compress_sync_properties(ranks, reference):
    """The reference test's properties on the port's own R: every rank holds
    the same synced gradient, it correlates with the true mean (> 0.3 at
    ratio 4), and the error feedback holds the residual."""
    g = reference["compress"]["g"]
    out = [r["compress"]["synced"][0] for r in ranks]
    for o in out[1:]:
        np.testing.assert_allclose(out[0], o, rtol=1e-5, atol=1e-6)
    mean = g.mean(axis=0)
    corr = float(np.dot(out[0], mean) / (np.linalg.norm(out[0]) * np.linalg.norm(mean) + 1e-9))
    assert corr > 0.3, corr
    for i, r in enumerate(ranks):
        np.testing.assert_allclose(r["compress"]["ef"][0], g[i] - out[0], rtol=1e-4, atol=1e-5)


def test_compress_sync_with_the_reference_r_equals_the_reference(ranks, reference):
    cs = reference["compress"]
    for i, r in enumerate(ranks):
        np.testing.assert_allclose(r["compress"]["synced_r"], cs["synced"][i],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["compress"]["ef_r"], cs["ef"][i], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_compress_sync_on_one_rank_keeps_the_rest(backend):
    """`mesh=None` is a world of one rank: per compressed leaf synced + new
    error feedback = gradient + old error feedback; a small leaf passes as
    it is and keeps its carry; the draw is the same each call."""
    rng = np.random.default_rng(3)
    grads = {"w": torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32)),
             "b": torch.from_numpy(rng.standard_normal((8,)).astype(np.float32))}
    ef = {"w": torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32)) * 0.1,
          "b": torch.ones(8)}
    cfg = compress.CompressConfig(ratio=4, chunk=512, min_size=64)
    synced, new_ef = compress.compress_sync(grads, ef, cfg, ("data",), mesh=None,
                                            backend=backend)
    v = grads["w"] + ef["w"]
    np.testing.assert_allclose((synced["w"] + new_ef["w"]).numpy(), v.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert not torch.allclose(synced["w"], v)
    assert torch.equal(synced["b"], grads["b"]) and new_ef["b"] is ef["b"]
    again, _ = compress.compress_sync(grads, ef, cfg, ("data",), mesh=None, backend=backend)
    assert torch.equal(again["w"], synced["w"])
