"""The port's LM serving path (configs, blocks, dense transformer, the
recurrent families RWKV-6 and Zamba-2, api, bridge, serve steps) on CPU
tensors against the JAX package.

Parameters are drawn by JAX and carried across with
`bridge.params_from_reference`; prompts and teacher-forced decode tokens
come from numpy with a seed (`torch_lm_parity`).  The reference runs
`api.prefill` / `api.decode_step` directly, without a mesh (jitted in f32,
op by op in bf16): its meshed serving factories are not used, because the
reference's own test of them fails
(`test_scheduler::TestStepTraffic::test_lm_prefill_decode_through_queue`).
MoE, the RP-compressed KV cache and the front-ends have their own files
(`test_torch_moe.py`, `test_torch_lm_zoo.py`); the recurrences' own
functions and the recurrent families through `DRService` are in
`test_torch_recurrent.py`."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.checkpoint import config_hash as j_config_hash
from repro.configs import registry as j_registry
from repro.models import api as j_api
from repro.models import blocks as j_blocks
from repro.models import transformer as j_transformer
from repro_torch.models import rwkv6 as t_rwkv6
from repro_torch.models import ssm as t_ssm
from repro_torch import bridge
from repro_torch.checkpoint import config_hash as t_config_hash
from repro_torch.configs import registry as t_registry
from repro_torch.models import api as t_api
from repro_torch.models import blocks as t_blocks
from repro_torch.models import transformer as t_transformer
from repro_torch.serve import serve_step
from repro_torch.serve.batching import BoundedCompileCache
from torch_lm_parity import CPU, CPU_KERNEL, TOL, close as _close, configs as _configs
from torch_lm_parity import np_tree as _np
from torch_lm_parity import serve_case

DENSE = ["h2o_danube3_4b", "yi_6b", "smollm_135m", "starcoder2_7b"]
TRANSFORMERS = [a for a in j_registry.ARCH_IDS
                if j_registry.get(a).family == "transformer"]
RECURRENT = ["rwkv6_1b6", "zamba2_7b"]
FAMILY_MODULES = {"transformer": t_transformer, "rwkv6": t_rwkv6, "zamba": t_ssm}
# each family's first dense leaf of a layer, drawn N(0, 1/d_model)
DENSE_LEAF = {"transformer": "wq", "rwkv6": "wr", "zamba": "in_proj"}
# leaves the reference's init sets without drawing
DETERMINISTIC = ("ln", "ln1", "ln2", "ln_x", "norm_y", "final_norm", "mix_r", "mix_k", "mix_v",
                 "mix_g", "mix_w", "cmix_r", "cmix_k", "w_base", "u_bonus", "d_skip", "dt_bias",
                 "conv_b")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", j_registry.ARCH_IDS)
def test_configs_equal_the_reference(arch_id):
    for get in ("get", "get_smoke"):
        jc, tc = getattr(j_registry, get)(arch_id), getattr(t_registry, get)(arch_id)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), (arch_id, get)
        assert (tc.dh, tc.padded_vocab, tc.param_count()) == (jc.dh, jc.padded_vocab,
                                                                jc.param_count())
        assert t_config_hash(tc) == j_config_hash(jc)
    assert t_registry.ALIASES == j_registry.ALIASES
    assert t_registry.ARCH_IDS == j_registry.ARCH_IDS


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_blocks_match_the_reference(dt):
    rng = np.random.default_rng(0)
    tol = TOL[dt]
    x = jnp.asarray(rng.standard_normal((2, 5, 3, 16)), dt)
    xt = bridge.to_tensor(np.asarray(x), device="cpu")
    w = jnp.asarray(rng.standard_normal(16), jnp.float32)
    wt = bridge.to_tensor(np.asarray(w), device="cpu")
    _close(t_blocks.rms_norm(xt, wt, 1e-5), j_blocks.rms_norm(x, w, 1e-5), tol)
    pos = np.array([[0, 3, 7, 100, 4095]], np.int32)
    _close(t_blocks.apply_rope(xt, torch.from_numpy(pos), 1e4),
           j_blocks.apply_rope(x, jnp.asarray(pos), 1e4), tol)
    for act in ("silu", "gelu", "relu"):
        _close(t_blocks.act_fn(act)(xt), j_blocks.act_fn(act)(x), tol, act)
    h = jnp.asarray(rng.standard_normal((2, 5, 16)), dt)
    ht = bridge.to_tensor(np.asarray(h), device="cpu")
    mp = {k: jnp.asarray(rng.standard_normal(s) * 0.2, dt)
          for k, s in (("w_in", (16, 24)), ("w_gate", (16, 24)), ("w_out", (24, 16)))}
    mpt = bridge.params_from_reference(_np(mp), device="cpu")
    _close(t_blocks.mlp(mpt, ht, "silu"), j_blocks.mlp(mp, h, "silu"), tol)
    plain = {k: mp[k] for k in ("w_in", "w_out")}
    _close(t_blocks.mlp({k: mpt[k] for k in plain}, ht, "gelu"),
           j_blocks.mlp(plain, h, "gelu"), tol)
    # decode attention over a partly filled ring, with and without a window
    q = jnp.asarray(rng.standard_normal((2, 1, 4, 16)), dt)
    kc = jnp.asarray(rng.standard_normal((2, 10, 2, 16)), dt)
    vc = jnp.asarray(rng.standard_normal((2, 10, 2, 16)), dt)
    qt, kct, vct = (bridge.to_tensor(np.asarray(a), device="cpu") for a in (q, kc, vc))
    for window in (None, 4):
        _close(t_blocks.decode_attention(qt, kct, vct, 7, window=window, scale_dh=16),
               j_blocks.decode_attention(q, kc, vc, jnp.int32(7), window=window,
                                         scale_dh=16), tol)


# ---------------------------------------------------------------------------
# params: layout and bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", TRANSFORMERS + ["hubert_xlarge:dr", "internvl2_1b:dr"]
                         + RECURRENT)
def test_init_params_layout_matches_the_reference(arch_id):
    """Every config's SMOKE layout (MoE's f32 router and stacked experts,
    the front-end projection, which reads the reduced features under a DR
    front-end; RWKV-6's mixes and decay LoRA; Zamba-2's stacked Mamba-2
    leaves and the shared block).  The leaves the reference sets without
    drawing equal its values exactly; `a_log` (log of a linspace) within
    one f32 ulp, since XLA's log on the CPU is not rounded as torch.log
    is."""
    arch_id, _, dr = arch_id.partition(":")
    jc, tc = _configs(arch_id)
    if dr:
        from repro.models.config import DRFrontendSpec as JSpec
        from repro_torch.models.config import DRFrontendSpec as TSpec
        jc = dataclasses.replace(jc, dr_frontend=JSpec(p=16, n=8))
        tc = dataclasses.replace(tc, dr_frontend=TSpec(p=16, n=8))
    want = jax.eval_shape(lambda: j_api.init_params(jax.random.PRNGKey(0), jc))
    got = t_api.init_params(torch.Generator().manual_seed(0), tc, execution=CPU)
    flat_w = {jax.tree_util.keystr(kp): (tuple(l.shape), str(l.dtype))
              for kp, l in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {p: (s, d.removeprefix("torch.")) for p, s, d in serve_step._tree_sig(got)}
    assert flat_g == flat_w
    std = float(got["layers"][DENSE_LEAF[tc.family]].std())
    assert abs(std - 1.0 / np.sqrt(tc.d_model)) < 0.2 / np.sqrt(tc.d_model)
    ref = _np(j_api.init_params(jax.random.PRNGKey(0), jc))
    for tree_g, tree_w in ((got, ref), (got["layers"], ref["layers"]),
                           (got.get("shared", {}), ref.get("shared", {}))):
        for name in DETERMINISTIC:
            if name in tree_w:
                np.testing.assert_array_equal(bridge.to_array(tree_g[name]), tree_w[name],
                                              err_msg=name)
    if tc.family == "zamba":
        np.testing.assert_array_max_ulp(bridge.to_array(got["layers"]["a_log"]),
                                        ref["layers"]["a_log"], maxulp=1)


@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16])
def test_bridge_round_trip_is_bit_exact(dt):
    jc, _ = _configs("h2o_danube3_4b")
    ref = jax.tree.map(lambda a: a.astype(dt), j_api.init_params(jax.random.PRNGKey(1), jc))
    ref_np = _np(ref)
    port = bridge.params_from_reference(ref_np, device="cpu")
    back = bridge.params_to_numpy(port)
    for (kp, a), b in zip(jax.tree_util.tree_flatten_with_path(ref_np)[0],
                          jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b, err_msg=str(kp))
    wq = port["layers"]["wq"]
    assert wq.dtype == (torch.float32 if dt == jnp.float32 else torch.bfloat16)
    bits = np.asarray(ref_np["layers"]["wq"]).view(np.int32 if dt == jnp.float32 else np.int16)
    np.testing.assert_array_equal(wq.view(torch.int32 if dt == jnp.float32 else torch.int16)
                                  .numpy(), bits)


# ---------------------------------------------------------------------------
# the LM against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", DENSE + ["rwkv6_1b6", "zamba2_7b", "zamba2_7b:64"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_the_reference(arch_id, compute_dtype):
    """Prefill + 6 decode steps, every cache leaf compared.  Zamba-2 runs
    its SSD step form at the default 12-token prompt and its block form at
    a 64-token one (`:64`, one SSD_CHUNK); decode steps take the step form."""
    arch_id, _, prompt = arch_id.partition(":")
    serve_case(*_configs(arch_id, compute_dtype), compute_dtype, CPU,
               prompt=int(prompt) if prompt else None)


@pytest.mark.parametrize("compute_dtype,arch_id", [
    pytest.param("float32", "h2o_danube3_4b", id="float32"),
    pytest.param("bfloat16", "h2o_danube3_4b", id="bfloat16"),
    pytest.param("float32", "rwkv6_1b6", id="float32-rwkv6_1b6"),
    pytest.param("float32", "zamba2_7b", id="float32-zamba2_7b"),
])
def test_kernel_backend_on_cpu_matches_the_reference(compute_dtype, arch_id):
    """backend="kernel" on CPU tensors runs the kernel wrapper's plain
    version: the SWA ring case through that route, and the recurrent
    families (Zamba-2's shared block reaches the flash wrapper; RWKV-6
    has no kernel on its path)."""
    serve_case(*_configs(arch_id, compute_dtype), compute_dtype, CPU_KERNEL)


def test_decode_matches_prefill_suffix():
    """Mirror of test_arch_smoke::test_decode_matches_prefill_suffix in the
    port alone: decode with the cache agrees with a teacher-forced full
    forward."""
    cfg = t_registry.get_smoke("yi_6b")
    params = t_api.init_params(torch.Generator().manual_seed(4), cfg, execution=CPU)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 12)))
    full, _ = t_transformer.forward(params, {"tokens": toks}, cfg, execution=CPU)
    logits, cache = t_api.prefill(params, {"tokens": toks[:, :8]}, cfg, 16, execution=CPU)
    np.testing.assert_allclose(logits.numpy(), full[:, 7].numpy(), rtol=2e-2, atol=2e-2)
    for i in range(8, 11):
        logits, cache = t_api.decode_step(params, toks[:, i], cache, cfg, execution=CPU)
        np.testing.assert_allclose(logits.numpy(), full[:, i].numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("prompt,agrees", [(20, False), (32, True)])
def test_swa_ring_matches_a_full_forward_only_after_whole_windows(prompt, agrees):
    """The reference's SWA ring (kept here for parity): after a prompt that
    is a multiple of the window (16), decode matches a teacher-forced full
    forward; after one that is not, the first decode step overwrites a key
    inside the window and the two disagree."""
    _, cfg = _configs("h2o_danube3_4b", "float32")
    params = t_api.init_params(torch.Generator().manual_seed(8), cfg, execution=CPU)
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size,
                                                              (1, prompt + 2)))
    full, _ = t_transformer.forward(params, {"tokens": toks}, cfg, execution=CPU)
    _, cache = t_api.prefill(params, {"tokens": toks[:, :prompt]}, cfg, 64, execution=CPU)
    diffs = []
    for i in range(prompt, prompt + 2):
        logits, cache = t_api.decode_step(params, toks[:, i], cache, cfg, execution=CPU)
        diffs.append(float((logits - full[:, i]).abs().max()))
    if agrees:
        assert max(diffs) < 1e-4, diffs
    else:
        assert min(diffs) > 0.1, diffs


def test_forward_matches_the_reference():
    jc, tc = _configs("starcoder2_7b", "float32")
    params = j_api.init_params(jax.random.PRNGKey(6), jc)
    toks = np.random.default_rng(7).integers(0, jc.vocab_size, (2, 40), dtype=np.int32)
    want, _ = j_transformer.forward(params, {"tokens": jnp.asarray(toks)}, jc, remat=False)
    got, aux = t_transformer.forward(bridge.params_from_reference(_np(params), device="cpu"),
                                     {"tokens": torch.from_numpy(toks)}, tc, execution=CPU)
    _close(got, want, 1e-4)
    assert (float(aux["moe_lb"]), float(aux["moe_z"]), aux["n_prefix"]) == (0.0, 0.0, 0)


@pytest.mark.parametrize("arch_id", ["h2o_danube3_4b"] + RECURRENT)
def test_init_cache_is_the_structural_twin_of_prefill(arch_id):
    """Every leaf of the reference's zero cache, by name, shape, dtype and
    value (RWKV-6: the decode state; Zamba-2: SSD and conv states beside
    one k / v slot per shared-block application), and of the port's
    prefill cache."""
    jc, tc = _configs(arch_id)
    want = j_api.init_cache(jc, 3, 40)
    got = t_api.init_cache(tc, 3, 40, execution=CPU)
    assert set(got) == set(want)
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        assert str(got[name].dtype).removeprefix("torch.") == str(want[name].dtype), name
        np.testing.assert_array_equal(bridge.to_array(got[name]), np.asarray(want[name],
                                                                             np.float32))
    params = t_api.init_params(torch.Generator().manual_seed(0), tc, execution=CPU)
    _, cache = t_api.prefill(params, {"tokens": torch.zeros((3, 5), dtype=torch.int32)}, tc, 40,
                             execution=CPU)
    assert serve_step._tree_sig(cache) == serve_step._tree_sig(got)


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def test_serve_steps_build_once_per_signature_within_the_bound():
    cfg = t_registry.get_smoke("h2o_danube3_4b")
    params = t_api.init_params(torch.Generator().manual_seed(0), cfg, execution=CPU)
    lru = BoundedCompileCache(maxsize=2)
    batch = {"tokens": torch.zeros((2, 6), dtype=torch.int32)}
    pre = serve_step.make_prefill(cfg, None, params, batch, 24, cache=lru, execution=CPU)
    assert serve_step.make_prefill(cfg, None, params, batch, 24, cache=lru,
                                   execution=CPU) is pre
    assert (lru.misses, lru.hits) == (1, 1)
    logits, cache = pre(params, batch)
    want_logits, _ = t_api.prefill(params, batch, cfg, 24, execution=CPU)
    np.testing.assert_array_equal(logits.numpy(), want_logits.numpy())
    dec = serve_step.make_decode(cfg, None, params, cache, cache=lru, execution=CPU)
    assert serve_step.make_decode(cfg, None, params, cache, cache=lru, execution=CPU) is dec
    logits, cache = dec(params, torch.ones((2,), dtype=torch.int32), cache)
    assert int(cache["pos"]) == 7 and tuple(logits.shape) == (2, cfg.padded_vocab)
    assert (lru.misses, lru.hits, len(lru)) == (2, 2, 2)
    # another signature (cache size, execution) builds anew and evicts the oldest
    serve_step.make_prefill(cfg, None, params, batch, 32, cache=lru, execution=CPU)
    serve_step.make_prefill(cfg, None, params, batch, 24, cache=lru, execution=CPU_KERNEL)
    assert (lru.misses, lru.evictions, len(lru)) == (4, 2, 2)
    # a mesh must be a named DeviceMesh (the meshed steps: tests/test_torch_mesh.py)
    with pytest.raises(TypeError, match="DeviceMesh"):
        serve_step.make_prefill(cfg, object(), params, batch, 24, cache=lru, execution=CPU)
    with pytest.raises(TypeError, match="DeviceMesh"):
        serve_step.make_decode(cfg, object(), params, cache, cache=lru, execution=CPU)


# ---------------------------------------------------------------------------
# the card rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", ["h2o_danube3_4b"] + RECURRENT)
def test_lm_entry_points_without_a_card_raise(arch_id):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    cfg = t_registry.get_smoke(arch_id)
    params = t_api.init_params(torch.Generator().manual_seed(0), cfg, execution=CPU)
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    _, cache = t_api.prefill(params, batch, cfg, 8, execution=CPU)
    tok = torch.zeros((1,), dtype=torch.int32)
    calls = [
        lambda: t_api.init_params(torch.Generator().manual_seed(0), cfg),
        lambda: t_api.prefill(params, batch, cfg, 8),
        lambda: t_api.decode_step(params, tok, cache, cfg),
        lambda: t_api.init_cache(cfg, 1, 8),
        lambda: FAMILY_MODULES[cfg.family].forward(params, batch, cfg),
        lambda: serve_step.make_prefill(cfg, None, params, batch, 8)(params, batch),
        lambda: serve_step.make_decode(cfg, None, params, cache)(params, tok, cache),
        lambda: bridge.params_from_reference({"w": np.zeros(2, np.float32)}),
        lambda: bridge.to_tensor(np.zeros(2, np.float32)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert int(cache["pos"]) == 4
