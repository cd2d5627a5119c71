"""The rest of the port's transformer family on CPU tensors against the JAX
package: the RP-compressed KV cache (`kv_rp`), the audio and vision
front-ends with and without the paper's RP→EASI DR front-end
(`repro_torch.train.train_step`), and LM steps through `DRService`'s
admission queue.

The reference's key sketch R comes across through numpy (the port's steps
take it as `kv_rp_r`); the port's own R is held to `tests/test_kv_rp.py`'s
checks.  DR states come from the reference through
`bridge.dr_state_from_reference`.  Tolerances are `test_torch_lm.py`'s:
1e-4 in f32, 2e-2 in bf16; a DR update at TRAJ (tests/test_kernels.py:162)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import dr_unit as j_dr_unit
from repro.models import api as j_api
from repro.models import transformer as j_transformer
from repro.models.config import DRFrontendSpec as JFront
from repro.train import train_step as j_ts
from repro_torch import bridge
from repro_torch.configs import registry as t_registry
from repro_torch.core import dr_unit as t_dr_unit
from repro_torch.models import api as t_api
from repro_torch.models import transformer as t_transformer
from repro_torch.models.config import DRFrontendSpec as TFront
from repro_torch.serve import DeadlineScheduler, DRService, VirtualClock
from repro_torch.train import train_step as t_ts
from torch_lm_parity import CPU, CPU_KERNEL, close, configs, serve_case

TRAJ = dict(rtol=5e-4, atol=5e-5)
FRONTENDS = ["hubert_xlarge", "internvl2_1b"]


# ---------------------------------------------------------------------------
# the RP-compressed KV cache
# ---------------------------------------------------------------------------

def _reference_r(jc):
    return bridge.to_tensor(np.asarray(j_transformer._kv_rp_matrix(jc)), device="cpu")


@pytest.mark.parametrize("arch_id", ["yi_6b", "h2o_danube3_4b", "phi35_moe"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_kv_rp_prefill_and_decode_match_the_reference(arch_id, compute_dtype):
    """The sketched key cache and the sketched decode scores against the
    reference, on the reference's own R (with SWA's ring, and under MoE)."""
    jc, tc = configs(arch_id, compute_dtype, kv_rp=2)
    serve_case(jc, tc, compute_dtype, CPU, kv_rp_r=_reference_r(jc))


def test_kv_rp_kernel_backend_on_cpu_matches_the_reference():
    jc, tc = configs("yi_6b", "float32", kv_rp=2)
    serve_case(jc, tc, "float32", CPU_KERNEL, kv_rp_r=_reference_r(jc))


@pytest.mark.parametrize("dh,ratio", [(64, 2), (128, 2), (120, 4)])
def test_port_sketch_is_ternary_with_density_one_over_s(dh, ratio):
    """The port's own R (seed 20180615): the reference's shape, entries in
    {0, ±scale} with the isometry scale sqrt(s/p) = 1, about 1/s of them
    nonzero (s = p), no dead output column, and the same R on every call."""
    cfg = dataclasses.replace(t_registry.get_smoke("yi_6b"), head_dim=dh, kv_rp=ratio)
    r = t_transformer.kv_rp_matrix(cfg, torch.device("cpu"))
    p = dh // ratio
    assert r.shape == (dh, p) and r.dtype == torch.float32
    assert set(torch.unique(r).tolist()) <= {-1.0, 0.0, 1.0}
    assert bool((r != 0).any(dim=0).all())
    nnz, expect = int((r != 0).sum()), dh * p / p
    assert abs(nnz - expect) <= 4 * np.sqrt(expect) + p * (1 - 1 / p) ** dh + 1, (nnz, expect)
    assert torch.equal(r, t_transformer.kv_rp_matrix(cfg, torch.device("cpu")))
    assert t_transformer.kv_rp_matrix(dataclasses.replace(cfg, kv_rp=None), "cpu") is None


@pytest.mark.parametrize("ratio", [2])
def test_port_kv_rp_decode_approximates_exact(ratio):
    """tests/test_kv_rp.py::test_kv_rp_decode_approximates_exact on the
    port alone, with the port's own R: decode logits keep their ranks."""
    base = dataclasses.replace(t_registry.get_smoke("yi_6b"), d_model=128, n_heads=2,
                               n_kv_heads=1, head_dim=64)
    compressed = dataclasses.replace(base, kv_rp=ratio)
    params = t_api.init_params(torch.Generator().manual_seed(0), base, execution=CPU)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, base.vocab_size, (2, 24)))
    logits_e, cache_e = t_api.prefill(params, {"tokens": toks}, base, 32, execution=CPU)
    logits_c, cache_c = t_api.prefill(params, {"tokens": toks}, compressed, 32, execution=CPU)
    assert cache_c["k"].shape[-1] == cache_e["k"].shape[-1] // ratio
    tok = logits_e.argmax(-1)
    for _ in range(3):
        logits_e, cache_e = t_api.decode_step(params, tok, cache_e, base, execution=CPU)
        logits_c, cache_c = t_api.decode_step(params, tok, cache_c, compressed, execution=CPU)
        for i in range(tok.shape[0]):
            ra = np.argsort(np.argsort(logits_e[i].numpy()))
            rb = np.argsort(np.argsort(logits_c[i].numpy()))
            corr = float(np.corrcoef(ra, rb)[0, 1])
            assert corr > 0.8, corr
        tok = logits_e.argmax(-1)


@pytest.mark.parametrize("arch_id", ["yi_6b", "h2o_danube3_4b"])
def test_kv_rp_cache_is_the_reference_shape_at_three_quarters_of_the_bytes(arch_id):
    """tests/test_kv_rp.py::test_kv_rp_cache_bytes at the full config (on
    the meta device: shapes only), and the structural twin of the
    reference's `init_cache`."""
    from repro.configs import registry as j_registry

    cfg = dataclasses.replace(t_registry.get(arch_id), kv_rp=2)
    jcfg = dataclasses.replace(j_registry.get(arch_id), kv_rp=2)
    meta = torch.device("meta")
    cache = t_transformer.init_cache(cfg, 4, 1024, meta)
    base = t_transformer.init_cache(dataclasses.replace(cfg, kv_rp=None), 4, 1024, meta)
    nbytes = lambda c: sum(t.numel() * t.element_size() for t in c.values())
    assert nbytes(cache) / nbytes(base) == pytest.approx(0.75, rel=0.02)
    want = jax.eval_shape(lambda: j_api.init_cache(jcfg, 4, 1024))
    for name in ("k", "v", "len", "pos"):
        assert tuple(cache[name].shape) == tuple(want[name].shape), name


# ---------------------------------------------------------------------------
# the audio / vision front-ends, with and without the DR front-end
# ---------------------------------------------------------------------------

def _decode_steps(jc):
    return 0 if jc.frontend == "audio" else 6   # the encoder has no decode step


@pytest.mark.parametrize("arch_id", FRONTENDS)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_frontend_prefill_and_decode_match_the_reference(arch_id, compute_dtype):
    jc, tc = configs(arch_id, compute_dtype)
    serve_case(jc, tc, compute_dtype, CPU, decode_steps=_decode_steps(jc))


def _dr_front(arch_id, compute_dtype, execution=CPU):
    """(configs with DRFrontendSpec(p=16, n=8), as examples/lm_dr_frontend.py
    sets it; (reference front, port front)): the reference's DR state after
    init and one update on the first 4096 normalised rows of a batch of raw
    features, as its train step does, imported into the port."""
    jc, tc = configs(arch_id, compute_dtype)
    jc = dataclasses.replace(jc, dr_frontend=JFront(p=16, n=8))
    tc = dataclasses.replace(tc, dr_frontend=TFront(p=16, n=8))
    j_dcfg, t_dcfg = j_ts._dr_cfg(jc), t_ts._dr_cfg(tc)
    raw = np.random.default_rng(21).standard_normal((4, 64, jc.frontend_dim)) * 3.0 + 1.0
    feats = j_ts._dr_normalize(jnp.asarray(raw.reshape(-1, jc.frontend_dim), jnp.float32))
    j_state = j_dr_unit.update(j_dr_unit.init(jax.random.PRNGKey(11), j_dcfg), j_dcfg,
                               feats[:4096])
    t_state = bridge.dr_state_from_reference(j_state, device="cpu")
    front = (lambda b: j_ts._apply_dr_frontend(j_state, j_dcfg, b),
             lambda b: t_ts._apply_dr_frontend(t_state, t_dcfg, b, execution=execution))
    return jc, tc, front


@pytest.mark.parametrize("arch_id", FRONTENDS)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_dr_frontend_prefill_and_decode_match_the_reference(arch_id, compute_dtype):
    """CONFIG_DR's path at SMOKE size: raw features through RP→EASI (16 → 8),
    then the projection of the reduced features, prefill and decode."""
    jc, tc, front = _dr_front(arch_id, compute_dtype)
    serve_case(jc, tc, compute_dtype, CPU, front=front, decode_steps=_decode_steps(jc))


def test_dr_frontend_kernel_backend_on_cpu_matches_the_reference():
    """backend="kernel" on CPU tensors through the DR front-end (the DR
    kernels' and flash's wrappers run their plain versions)."""
    jc, tc, front = _dr_front("internvl2_1b", "float32", CPU_KERNEL)
    serve_case(jc, tc, "float32", CPU_KERNEL, front=front)


@pytest.mark.parametrize("arch_id", FRONTENDS)
def test_dr_cfg_and_normalize_match_the_reference(arch_id):
    jc, tc, _ = _dr_front(arch_id, "float32")
    want, got = j_ts._dr_cfg(jc), t_ts._dr_cfg(tc)
    assert {f.name: getattr(got, f.name) for f in dataclasses.fields(got) if f.name != "dtype"} \
        == {f.name: getattr(want, f.name) for f in dataclasses.fields(want) if f.name != "dtype"}
    assert t_ts._dr_cfg(t_registry.get_smoke(arch_id)) is None
    raw = np.random.default_rng(3).standard_normal((300, jc.frontend_dim)).astype(np.float32)
    raw = raw * np.linspace(0.1, 30.0, jc.frontend_dim, dtype=np.float32) - 7.0
    close(t_ts._dr_normalize(torch.from_numpy(raw)), j_ts._dr_normalize(jnp.asarray(raw)),
          1e-5, "normalised")


@pytest.mark.parametrize("arch_id", FRONTENDS)
@pytest.mark.parametrize("execution", [CPU, CPU_KERNEL], ids=["torch", "kernel"])
def test_dr_frontend_update_and_transform_match_the_reference(arch_id, execution):
    """The train step's DR fold (one `dr_unit.update` on the first 4096
    normalised rows) from an imported initial state, then
    `_apply_dr_frontend` on a batch, each against the reference."""
    jc, tc, _ = _dr_front(arch_id, "float32")
    j_dcfg, t_dcfg = j_ts._dr_cfg(jc), t_ts._dr_cfg(tc)
    key = "frames" if jc.frontend == "audio" else "patches"
    raw = np.random.default_rng(4).standard_normal((3, 50, jc.frontend_dim)).astype(np.float32)
    j0 = j_dr_unit.init(jax.random.PRNGKey(12), j_dcfg)
    flat = raw.reshape(-1, jc.frontend_dim)
    j1 = j_dr_unit.update(j0, j_dcfg, j_ts._dr_normalize(jnp.asarray(flat))[:4096])
    t1 = t_dr_unit.update(bridge.dr_state_from_reference(j0, device="cpu"), t_dcfg,
                          t_ts._dr_normalize(torch.from_numpy(flat))[:4096],
                          execution=execution)
    np.testing.assert_array_equal(t1.r.numpy(), np.asarray(j1.r))
    np.testing.assert_allclose(t1.b.numpy(), np.asarray(j1.b), **TRAJ)
    assert int(t1.steps) == int(j1.steps) == 1
    want = j_ts._apply_dr_frontend(j1, j_dcfg, {key: jnp.asarray(raw)})
    got = t_ts._apply_dr_frontend(t1, t_dcfg, {key: torch.from_numpy(raw)},
                                  execution=execution)
    assert got[key].shape == (3, 50, 8)
    close(got[key], want[key], 1e-4, key)
    assert t_ts._apply_dr_frontend(None, t_dcfg, {key: raw})[key] is raw


# ---------------------------------------------------------------------------
# LM steps through DRService's admission queue
# ---------------------------------------------------------------------------

def _lm(arch_id="smollm_135m"):
    cfg = t_registry.get_smoke(arch_id)
    params = t_api.init_params(torch.Generator().manual_seed(0), cfg, execution=CPU)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8),
                                                                 dtype=np.int32))
    return cfg, params, prompts


def test_lm_prefill_decode_through_queue():
    """The port's twin of tests/test_scheduler.py::TestStepTraffic::
    test_lm_prefill_decode_through_queue, with mesh=None (that reference
    test is one of the reference's own failures): a real prefill and decode
    admitted through the DeadlineScheduler, built in the SERVICE's bounded
    cache (one LRU for DR + LM programs); the prefill flushes at its
    deadline.  The answers equal the direct steps bit for bit."""
    cfg, params, prompts = _lm()
    clk = VirtualClock()
    svc = DRService(clock=clk)
    sched = DeadlineScheduler(svc, default_max_delay_ms=5.0, start=False)
    tp = sched.lm_prefill(cfg, None, params, {"tokens": prompts}, 16, execution=CPU)
    assert not tp.done
    clk.advance(5.0)
    sched.poll()
    logits, cache = tp.result()
    assert logits.shape == (2, cfg.vocab_size)
    want, want_cache = t_api.prefill(params, {"tokens": prompts}, cfg, 16, execution=CPU)
    assert torch.equal(logits, want)

    tok = logits.argmax(-1).to(torch.int32)
    td = sched.lm_decode(cfg, None, params, tok, cache, max_delay_ms=0.0, execution=CPU)
    sched.poll()
    logits2, cache2 = td.result()
    assert logits2.shape == (2, cfg.vocab_size)
    want2, _ = t_api.decode_step(params, tok, want_cache, cfg, execution=CPU)
    assert torch.equal(logits2, want2) and int(cache2["pos"]) == 9
    assert svc.cache.misses == 2                     # prefill + decode builds
    slo = svc.metrics()["slo"]["lm"]
    assert set(slo) == {"prefill", "decode"}
    assert slo["prefill"]["e2e"]["p50_ms"] == 5.0    # flushed at deadline
    sched.shutdown()


def test_service_lm_steps_share_the_dr_programs_cache():
    """`DRService.lm_prefill` / `lm_decode` (no scheduler): the steps are
    admitted through the same queue as DR requests, resolve at `flush`, and
    build once per signature in the same bounded LRU as the DR bucket
    programs; the rows of a vision batch are its leading dim."""
    from repro_torch import dr as tdr
    from repro_torch.serve import BucketPolicy

    svc = DRService(buckets=BucketPolicy(min_bucket=4, max_bucket=8), clock=VirtualClock())
    model = tdr.DRModel(stages=(tdr.RPStage(32, 16), tdr.EASIStage.rotation(16, 8, mu=1e-3)),
                        execution=tdr.Execution(device="cpu"), block_size=4)
    svc.register("m", model, model.init(torch.Generator().manual_seed(0)))
    svc.submit("m", torch.ones((3, 32)))
    svc.flush()
    dr_builds = svc.cache.misses                     # the 4-row bucket's program
    assert dr_builds == 1
    cfg, params, prompts = _lm("internvl2_1b")
    patches = torch.zeros((2, cfg.frontend_seq, cfg.frontend_dim))
    batch = {"patches": patches, "tokens": prompts}
    fn, rows = svc.prefill_step(cfg, None, params, batch, 24, execution=CPU)
    assert rows == 2
    tickets = [svc.lm_prefill(cfg, None, params, batch, 24, execution=CPU) for _ in range(2)]
    t_dr = svc.submit("m", torch.ones((3, 32)))
    svc.flush()
    (l1, c1), (l2, _) = (t.result() for t in tickets)
    assert torch.equal(l1, l2) and t_dr.result().shape == (3, 8)
    assert int(c1["pos"]) == cfg.frontend_seq + 8
    td = svc.lm_decode(cfg, None, params, l1.argmax(-1), c1, execution=CPU)
    svc.flush()
    assert td.result()[0].shape == (2, cfg.padded_vocab)
    assert svc.cache.misses == dr_builds + 2 and len(svc.cache) == 3
    assert svc.prefill_step(cfg, None, params, batch, 24, execution=CPU)[0] is fn
    with pytest.raises(TypeError, match="DeviceMesh"):
        svc.lm_prefill(cfg, object(), params, batch, 24, execution=CPU)
