"""The port's recurrent LM families on CPU tensors against the JAX package:
RWKV-6's WKV recurrence and mixes (`repro_torch.models.rwkv6`), Mamba-2's
causal conv and SSD block in both of its forms (`repro_torch.models.ssm`),
the port's twins of the reference's own recurrence checks, and both
families served through `DRService`'s queue.

Inputs come from numpy with a seed; parameters are drawn by JAX and carried
across with `bridge.params_from_reference`.  Tolerances are
`test_torch_lm.py`'s (1e-4 in f32, 2e-2 in bf16), and bf16 references run
op by op under `jax.disable_jit()` so that every op rounds once, as the
port's do.  The twin of the reference's block-form gradient check
(`tests/test_ssd_block.py::test_block_gradients_match`) is in
`test_torch_train.py`, with the LM backward."""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models import rwkv6 as j_rwkv6
from repro.models import ssm as j_ssm
from repro_torch import bridge
from repro_torch.configs import registry as t_registry
from repro_torch.models import api as t_api
from repro_torch.models import blocks as t_blocks
from repro_torch.models import rwkv6 as t_rwkv6
from repro_torch.models import ssm as t_ssm
from repro_torch.serve import DRService, VirtualClock, serve_step
from torch_lm_parity import CPU, TOL, close, configs, np_tree

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dt):
    """(reference array in dt, the port's tensor with the same values)."""
    j = jnp.asarray(a, DTYPES[dt][0])
    return j, bridge.to_tensor(np.asarray(j), device="cpu")


def _cast_j(lp, dt):
    jdt = DTYPES[dt][0]
    return jax.tree.map(lambda a: a.astype(jdt) if a.dtype == jnp.float32 and a.ndim >= 2
                        else a, lp)


def _ref_mode(dt):
    return jax.disable_jit() if dt == "bfloat16" else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

def _rwkv_layer(dt, seed=0):
    jc, tc = configs("rwkv6_1b6", dt)
    params = j_rwkv6.init_params(jax.random.PRNGKey(seed), jc)
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    rng = np.random.default_rng(seed)
    # nonzero mixes, bonus and decay base, so every term of the layer counts
    lp = {**lp, "u_bonus": jnp.asarray(rng.standard_normal(lp["u_bonus"].shape) * 0.5,
                                       jnp.float32),
          "mix_k": jnp.asarray(rng.uniform(0, 1, lp["mix_k"].shape), jnp.float32),
          "w_base": jnp.asarray(rng.uniform(-2, 0, lp["w_base"].shape), jnp.float32)}
    lp_j = _cast_j(lp, dt)
    lp_t = t_blocks.cast(bridge.params_from_reference(np_tree(lp), device="cpu"),
                         DTYPES[dt][1])
    return jc, tc, lp_j, lp_t, rng


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_wkv_scan_matches_the_reference(dt):
    """The WKV6 recurrence from a nonzero state: outputs in r's dtype, the
    final state in f32."""
    rng = np.random.default_rng(1)
    b, s, h, dh = 2, 9, 3, 64
    r, k, v = (_pair(rng.standard_normal((b, s, h, dh)), dt) for _ in range(3))
    w = rng.uniform(0.5, 1.0, (b, s, h, dh)).astype(np.float32)
    u = (rng.standard_normal((h, dh)) * 0.5).astype(np.float32)
    st = (rng.standard_normal((b, h, dh, dh)) * 0.3).astype(np.float32)
    with _ref_mode(dt):
        want_out, want_st = j_rwkv6._wkv_scan(r[0], k[0], v[0], jnp.asarray(w), jnp.asarray(u),
                                              jnp.asarray(st))
    state0 = torch.from_numpy(st.copy())
    got_out, got_st = t_rwkv6._wkv_scan(r[1], k[1], v[1], torch.from_numpy(w),
                                        torch.from_numpy(u), state0)
    assert got_out.dtype == DTYPES[dt][1] and got_st.dtype == torch.float32
    close(got_out, want_out, TOL[dt], "out")
    close(got_st, want_st, TOL[dt], "state")
    np.testing.assert_array_equal(state0.numpy(), st)        # the given state is not written


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_time_mix_and_channel_mix_match_the_reference(dt):
    """One layer's time mix (from a nonzero shift and WKV state) and channel
    mix, on the reference's layer parameters."""
    jc, tc, lp_j, lp_t, rng = _rwkv_layer(dt)
    b, s, d = 2, 7, jc.d_model
    nh = d // j_rwkv6.HEAD_DIM
    x, prev, prev_c = _pair(rng.standard_normal((b, s, d)), dt), \
        _pair(rng.standard_normal((b, d)), dt), _pair(rng.standard_normal((b, d)), dt)
    st = (rng.standard_normal((b, nh, 64, 64)) * 0.3).astype(np.float32)
    with _ref_mode(dt):
        want = j_rwkv6._time_mix(lp_j, x[0], prev[0], jnp.asarray(st), jc, nh)
        want_c = j_rwkv6._channel_mix(lp_j, x[0], prev_c[0])
    got = t_rwkv6._time_mix(lp_t, x[1], prev[1], torch.from_numpy(st), tc, nh)
    got_c = t_rwkv6._channel_mix(lp_t, x[1], prev_c[1])
    for name, g, w in zip(("out", "shift", "state"), got, want):
        close(g, w, TOL[dt], f"time mix {name}")
    for name, g, w in zip(("out", "shift"), got_c, want_c):
        close(g, w, TOL[dt], f"channel mix {name}")


def test_rwkv_decode_matches_forward():
    """Twin of tests/test_arch_smoke.py::test_rwkv_decode_matches_forward in
    the port alone: prefill of 6 tokens, then decode steps, against the
    full forward's logits at each position."""
    cfg = t_registry.get_smoke("rwkv6_1b6")
    params = t_api.init_params(torch.Generator().manual_seed(6), cfg, execution=CPU)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 10)))
    full, _, _ = t_rwkv6.forward(params, {"tokens": toks}, cfg, execution=CPU)
    logits, state = t_api.prefill(params, {"tokens": toks[:, :6]}, cfg, 0, execution=CPU)
    np.testing.assert_allclose(logits.numpy(), full[:, 5].numpy(), rtol=2e-2, atol=2e-2)
    for i in range(6, 9):
        logits, state = t_api.decode_step(params, toks[:, i], state, cfg, execution=CPU)
        np.testing.assert_allclose(logits.numpy(), full[:, i].numpy(), rtol=2e-2, atol=2e-2)
    assert int(state["pos"]) == 9


# ---------------------------------------------------------------------------
# Mamba-2: the causal conv and the SSD block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_causal_conv_matches_the_reference(dt, with_state):
    """The depthwise causal conv with and without a carried state.  In bf16
    the port sums the taps in f32 and rounds once, and the outputs equal
    XLA's bit for bit: that is where XLA's depthwise conv rounds on the CPU
    (summing the taps in bf16 moves thousands of outputs by an ulp).  In
    f32 the summation order differs, within 1e-6."""
    rng = np.random.default_rng(2)
    b, s, c, k = 2, 11, 40, 4
    x = _pair(rng.standard_normal((b, s, c)), dt)
    w = (rng.standard_normal((k, 1, c)) * 0.5).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    st = _pair(rng.standard_normal((b, k - 1, c)), dt) if with_state else (None, None)
    with _ref_mode(dt):
        want_y, want_st = j_ssm._causal_conv(x[0], jnp.asarray(w, DTYPES[dt][0]),
                                             jnp.asarray(bias), st[0])
    got_y, got_st = t_ssm._causal_conv(x[1], torch.from_numpy(w).to(DTYPES[dt][1]),
                                       torch.from_numpy(bias), st[1])
    np.testing.assert_array_equal(bridge.to_array(got_st), np.asarray(want_st, np.float32))
    if dt == "bfloat16":
        # the conv alone (before bias and silu), where the rounding point sits
        pad = st[1] if with_state else torch.zeros((b, k - 1, c), dtype=torch.bfloat16)
        xin = torch.cat([pad, x[1]], dim=1)
        with _ref_mode(dt):
            conv = jax.lax.conv_general_dilated(
                jnp.asarray(np.asarray(xin.float()), jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                window_strides=(1,), padding="VALID", dimension_numbers=("NHC", "HIO", "NHC"),
                feature_group_count=c)
        taps_f32 = sum(xin[:, j:j + s].float() * torch.from_numpy(w).bfloat16().float()[j, 0]
                       for j in range(k)).to(torch.bfloat16)
        np.testing.assert_array_equal(bridge.to_array(taps_f32), np.asarray(conv, np.float32))
        taps_bf16 = sum(xin[:, j:j + s] * torch.from_numpy(w).bfloat16()[j, 0] for j in range(k))
        assert bool((taps_bf16 != taps_f32).any())
        close(got_y, want_y, TOL[dt])
    else:
        close(got_y, want_y, 1e-6)


def _mamba_case(dt, seed=0):
    jc, tc = configs("zamba2_7b", dt)
    spec = jc.ssm
    d = jc.d_model
    lp = j_ssm.mamba_init(jax.random.PRNGKey(seed), jc, jnp.float32)
    lp_j = _cast_j(lp, dt)
    lp_t = t_blocks.cast(bridge.params_from_reference(np_tree(lp), device="cpu"),
                         DTYPES[dt][1])
    rng = np.random.default_rng(seed + 1)
    shape = (2, spec.n_heads(d), spec.head_dim, spec.d_state)
    conv_ch = spec.d_inner(d) + 2 * spec.d_state
    return jc, tc, lp_j, lp_t, rng, shape, conv_ch


@pytest.mark.parametrize("nonzero_ssm", [False, True])
@pytest.mark.parametrize("form,dt", [("block", "float32"), ("step", "float32"),
                                     ("block", "bfloat16"), ("step", "bfloat16")])
def test_mamba_block_matches_the_reference(form, dt, nonzero_ssm):
    """`mamba_block` in the block form (S = 2 SSD chunks) and the step form
    (S = 13), from a zero or a nonzero SSD state, with a nonzero conv state:
    output, SSD state and conv state."""
    jc, tc, lp_j, lp_t, rng, shape, conv_ch = _mamba_case(dt)
    s = 2 * t_ssm.SSD_CHUNK if form == "block" else 13
    assert j_ssm.SSD_CHUNK == t_ssm.SSD_CHUNK
    x = _pair(rng.standard_normal((2, s, jc.d_model)) * 0.5, dt)
    st = (rng.standard_normal(shape) * 0.1 * nonzero_ssm).astype(np.float32)
    conv = _pair(rng.standard_normal((2, jc.ssm.d_conv - 1, conv_ch)), dt)
    with _ref_mode(dt):
        want = j_ssm.mamba_block(lp_j, x[0], jc, jnp.asarray(st), conv[0])
    got = t_ssm.mamba_block(lp_t, x[1], tc, torch.from_numpy(st), conv[1])
    for name, g, w in zip(("y", "ssm state", "conv state"), got, want):
        close(g, w, TOL[dt], f"{form} form {name}")


@pytest.mark.parametrize("nonzero_state", [False, True])
def test_ssd_block_form_matches_the_step_form(nonzero_state, monkeypatch):
    """Twins of tests/test_ssd_block.py::test_block_matches_step_scan and
    ::test_nonzero_initial_state_carries in the port alone: at S = 128 the
    block form and the step form (SSD_CHUNK forced past S) agree, with a
    zero and a carried nonzero initial state."""
    cfg = t_registry.get_smoke("zamba2_7b")
    spec = cfg.ssm
    gen = torch.Generator().manual_seed(0)
    lp = t_ssm.mamba_init(gen, cfg, torch.float32, torch.device("cpu"))
    x = torch.randn((2, 128, cfg.d_model), generator=gen) * 0.5
    st = torch.randn((2, spec.n_heads(cfg.d_model), spec.head_dim, spec.d_state),
                     generator=gen) * 0.1 * nonzero_state
    y_blk, h_blk, _ = t_ssm.mamba_block(lp, x, cfg, st, None)
    monkeypatch.setattr(t_ssm, "SSD_CHUNK", 10 ** 9)
    y_seq, h_seq, _ = t_ssm.mamba_block(lp, x, cfg, st, None)
    np.testing.assert_allclose(y_blk.numpy(), y_seq.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h_blk.numpy(), h_seq.numpy(), rtol=2e-4, atol=2e-4)


def test_zamba_decode_matches_a_longer_prefill():
    """Prefill 64 tokens (block form), then 4 teacher-forced decode steps
    (step form, the shared block's KV ring), against prefills of the longer
    prompts, in f32."""
    _, cfg = configs("zamba2_7b", "float32")
    params = t_api.init_params(torch.Generator().manual_seed(8), cfg, execution=CPU)
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 68)))
    logits, cache = t_api.prefill(params, {"tokens": toks[:, :64]}, cfg, 68, execution=CPU)
    for i in range(64, 68):
        logits, cache = t_api.decode_step(params, toks[:, i], cache, cfg, execution=CPU)
        want, _ = t_api.prefill(params, {"tokens": toks[:, :i + 1]}, cfg, 68, execution=CPU)
        np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    assert (int(cache["len"]), int(cache["pos"])) == (68, 68)


# ---------------------------------------------------------------------------
# the recurrent families through DRService's queue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", ["rwkv6_1b6", "zamba2_7b"])
def test_service_serves_the_recurrent_families(arch_id):
    """`DRService.lm_prefill` / `lm_decode` with mesh=None answer as the
    direct `serve_step` calls do, bit for bit, and `make_decode` builds
    once per state signature in the service's LRU: a second request with
    the same state shapes reuses it, another batch builds anew."""
    cfg = t_registry.get_smoke(arch_id)
    params = t_api.init_params(torch.Generator().manual_seed(0), cfg, execution=CPU)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8),
                                                                 dtype=np.int32))
    svc = DRService(clock=VirtualClock())

    def serve(batch):
        tp = svc.lm_prefill(cfg, None, params, batch, 16, execution=CPU)
        svc.flush()
        logits, state = tp.result()
        outs = [logits]
        for _ in range(3):
            td = svc.lm_decode(cfg, None, params, logits.argmax(-1).to(torch.int32), state,
                               execution=CPU)
            svc.flush()
            logits, state = td.result()
            outs.append(logits)
        return outs, state

    got, state = serve({"tokens": prompts})
    pre = serve_step.make_prefill(cfg, None, params, {"tokens": prompts}, 16, execution=CPU)
    logits, want_state = pre(params, {"tokens": prompts})
    dec = serve_step.make_decode(cfg, None, params, want_state, execution=CPU)
    want = [logits]
    for _ in range(3):
        logits, want_state = dec(params, logits.argmax(-1).to(torch.int32), want_state)
        want.append(logits)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert serve_step._tree_sig(state) == serve_step._tree_sig(want_state)
    for name in state:
        assert torch.equal(state[name], want_state[name]), name
    assert int(state["pos"]) == 11
    assert svc.cache.misses == 2                      # one prefill, one decode build
    serve({"tokens": prompts.flip(0)})
    assert svc.cache.misses == 2 and svc.cache.hits >= 4
    serve({"tokens": prompts[:1]})                     # another state signature
    assert svc.cache.misses == 4
    assert set(svc.metrics()["slo"]["lm"]) == {"prefill", "decode"}
