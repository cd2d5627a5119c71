"""The port's LM training path on CPU tensors against the JAX package: the
loss and its gradients for every family (`api.loss_fn`), attention's
backward (`blocks.FlashAttentionFn` over `ref.flash_attention_bwd_ref`)
and its lse, the chunked cross-entropy, the recurrences' checkpointed
gradients, the train step with grad-accumulation and the DR front-end
co-trained, the synthetic data streams, the checkpoint manager (its
format read and written by both packages), the trainer and the launch
CLI.

Parameters and train states are drawn by JAX and carried across with
`bridge`; data comes from numpy with a seed (or the synthetic streams,
equal in both packages).  The reference runs jitted.  Tolerances: f32
losses at `TOL["float32"]` (1e-4), every f32 gradient leaf within 1e-4 of
the reference's in relative norm; in bf16 the loss at 2e-2 and each
gradient leaf within 5e-2 in relative norm (jitted XLA keeps fused bf16
intermediates in f32 where the port rounds each op, and the backward
carries those differences through every layer: the leaves read 0.6–3e-2
on these inputs).

The reference's own meshed `make_train_step` is not used: it needs a mesh,
and the reference's test of its trainer on that mesh fails
(`tests/test_fault_tolerance.py::TestResume`).  The reference step here is
built from the reference's parts (`make_loss`, `jax.value_and_grad`,
`optimizer.apply_updates`, `dr_unit.update`) under `jax.jit` with no mesh,
in the order its step runs them.  For the same reason the trainer's
interrupted-vs-uninterrupted run is a property of the port alone here."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import registry as j_registry
from repro.core import dr_unit as j_dr_unit
from repro.data import synthetic as j_synthetic
from repro.models import api as j_api
from repro.models import blocks as j_blocks
from repro.models import rwkv6 as j_rwkv6
from repro.models.config import DRFrontendSpec as JSpec
from repro.train import optimizer as j_opt
from repro.train import train_step as j_ts
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager, leaf_hash
from repro_torch.checkpoint.manager import flatten_with_path
from repro_torch.configs import registry as t_registry
from repro_torch.data import synthetic as t_synthetic
from repro_torch.kernels import ref as t_ref
from repro_torch.launch import train as t_launch
from repro_torch.models import api as t_api
from repro_torch.models import blocks as t_blocks
from repro_torch.models import rwkv6 as t_rwkv6
from repro_torch.models import ssm as t_ssm
from repro_torch.models.config import DRFrontendSpec as TSpec
from repro_torch.train import optimizer as t_opt
from repro_torch.train import train_step as t_ts
from repro_torch.train import trainer as t_trainer
from torch_lm_parity import CPU, CPU_KERNEL, TOL, configs, np_tree

GRAD_REL = {"float32": 1e-4, "bfloat16": 5e-2}


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _port_leaves(tree):
    """{path: numpy} of a port tree; the checkpoint manager's walk gives
    `jax.tree_util.keystr`'s strings."""
    return {p: bridge.to_array(t) if isinstance(t, torch.Tensor) else np.asarray(t)
            for p, t in flatten_with_path(tree)}


def _assert_equal_leaves(got, want):
    """Same paths, and each leaf equal in shape, dtype and every value."""
    assert set(got) == set(want)
    for path in want:
        assert (got[path].shape, got[path].dtype) == (want[path].shape, want[path].dtype), path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def _ref_leaves(tree):
    """{path: numpy} of a reference tree (bf16 widened to f32)."""
    return {jax.tree_util.keystr(kp): np.asarray(l, np.float32) if l.dtype == jnp.bfloat16
            else np.asarray(l) for kp, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _lm_batch(cfg, seq, *, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)}
    if cfg.frontend == "audio":
        out["frames"] = rng.standard_normal((batch, seq, cfg.frontend_dim)).astype(np.float32)
    elif cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (batch, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
    return out


def _requires_grad(params):
    leaves = [t.requires_grad_(True) for t in t_opt.tree_leaves(params)]
    return t_opt.tree_unflatten(params, leaves), leaves


# ---------------------------------------------------------------------------
# the loss and its gradients, every family
# ---------------------------------------------------------------------------

LOSS_CASES = [(a, dt) for a in j_registry.ARCH_IDS for dt in ("float32", "bfloat16")] + [
    ("zamba2_7b:64", "float32"), ("rwkv6_1b6:128", "float32")]


@pytest.mark.parametrize("arch_id,compute_dtype", LOSS_CASES,
                         ids=[f"{a}-{d}" for a, d in LOSS_CASES])
def test_loss_and_grads_match_the_reference(arch_id, compute_dtype):
    """`api.loss_fn` and every gradient leaf against
    `jax.value_and_grad(repro.models.api.loss_fn)` at each config's SMOKE
    size, 2 × 16 tokens; `:64` runs Zamba-2's SSD block form (one
    checkpointed chunk), `:128` RWKV-6's WKV in two checkpointed chunks."""
    arch_id, _, seq = arch_id.partition(":")
    jc, tc = configs(arch_id, compute_dtype)
    params = j_api.init_params(jax.random.PRNGKey(1), jc)
    batch = _lm_batch(jc, int(seq) if seq else 16)
    (want, w_aux), w_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_api.loss_fn(p, b, jc), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams, leaves = _requires_grad(bridge.params_from_reference(np_tree(params), device="cpu"))
    got, aux = t_api.loss_fn(tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, tc,
                             execution=CPU)
    grads = torch.autograd.grad(got, leaves, allow_unused=True, materialize_grads=True)
    tol = TOL[compute_dtype]
    np.testing.assert_allclose(float(got), float(want), rtol=tol, atol=tol)
    assert set(aux) == set(w_aux)
    for name in w_aux:
        np.testing.assert_allclose(float(aux[name]), float(w_aux[name]), rtol=tol, atol=tol)
    g = _port_leaves(t_opt.tree_unflatten(tparams, grads))
    w = _ref_leaves(w_grads)
    assert set(g) == set(w)
    for path in w:
        assert g[path].shape == w[path].shape, path
        rel = _rel(g[path], w[path])
        assert rel <= GRAD_REL[compute_dtype], (path, rel)


# ---------------------------------------------------------------------------
# attention: lse and the backward
# ---------------------------------------------------------------------------

def _qkv(b, sq, skv, hq, hkv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh), (b, sq, hq, dh))]


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24), (False, None)])
def test_flash_attention_gradients_match_the_reference(causal, window, dt, backend):
    """tests/test_blocks.py::test_flash_gradients_match_naive's cases (2 × 64
    positions, 4/2 heads, Dh 16, chunks 16 × 32): the output and dq, dk, dv
    of `flash_attention` (through `FlashAttentionFn`; `backend="kernel"`
    on CPU tensors runs the kernel wrapper's plain version) against
    `jax.grad` through the reference's custom VJP.  Every row sees a key."""
    q, k, v, ct = _qkv(2, 64, 64, 4, 2, 16)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "float32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    kw = dict(causal=causal, window=window, q_chunk=16, kv_chunk=32)

    def j_loss(q_, k_, v_):
        out = j_blocks.flash_attention(q_, k_, v_, **kw)
        return jnp.sum(out.astype(jnp.float32) * ct), out

    (_, want), w_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    tq, tk, tv = (bridge.to_tensor(np.asarray(jnp.asarray(a, jdt)), device="cpu")
                  .requires_grad_(True) for a in (q, k, v))
    out = t_blocks.flash_attention(tq, tk, tv, backend=backend, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    (out.to(torch.float32) * torch.from_numpy(ct)).sum().backward()
    tol = dict(rtol=2e-4, atol=2e-5) if dt == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(bridge.to_array(out), np.asarray(want, np.float32), **tol)
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), w_grads):
        assert g.dtype == tdt
        np.testing.assert_allclose(bridge.to_array(g), np.asarray(w, np.float32), **tol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal,window,sq,skv,q_offset", [
    (True, None, 64, 64, 0), (True, 24, 64, 64, 0), (False, None, 48, 80, 0),
    (True, 20, 40, 100, 60)])
def test_lse_matches_the_reference(causal, window, sq, skv, q_offset):
    """The plain version's lse (B, Hq, Sq) against the reference's
    `_flash_forward` residual, f32, chunks 16 × 32 (ragged Sq and Skv)."""
    q, k, v, _ = _qkv(2, sq, skv, 4, 2, 16, seed=1)
    b, hq, hkv, dh = 2, 4, 2, 16
    cq, ck = 16, 32
    nq, nk = -(-sq // cq), -(-skv // ck)
    qp = np.pad(q, ((0, 0), (0, nq * cq - sq), (0, 0), (0, 0)))
    kp = np.pad(k, ((0, 0), (0, nk * ck - skv), (0, 0), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, nk * ck - skv), (0, 0), (0, 0)))
    qg = jnp.asarray(qp.reshape(b, nq, cq, hkv, hq // hkv, dh))
    kc = jnp.asarray(kp.reshape(b, nk, ck, hkv, dh).transpose(1, 0, 2, 3, 4))
    vc = jnp.asarray(vp.reshape(b, nk, ck, hkv, dh).transpose(1, 0, 2, 3, 4))
    _, lse = j_blocks._flash_forward(qg, kc, vc, causal=causal, window=window, cq=cq, ck=ck,
                                     q_offset=q_offset, skv_true=skv)
    want = np.asarray(lse).reshape(b, nq * cq, hq)[:, :sq].transpose(0, 2, 1)
    out, got = t_ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                         causal=causal, window=window, q_offset=q_offset,
                                         q_chunk=cq, kv_chunk=ck, return_lse=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, hq, sq)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # with return_lse the output is the same as without
    assert torch.equal(out, t_ref.flash_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal, window=window,
        q_offset=q_offset, q_chunk=cq, kv_chunk=ck))


def test_rows_that_see_no_key_get_no_gradient():
    """q at positions 14..21 over 16 keys, causal, window 4: rows 5..7 see
    no key.  Their output is 0 (the port's p = 0 rule), their lse about
    −1e30, their dq 0, and they add nothing to dk / dv; the rows that see a
    key get the gradients of a dense softmax over their visible keys."""
    q, k, v, ct = _qkv(2, 8, 16, 4, 2, 16, seed=2)
    kw = dict(causal=True, window=4, q_offset=14)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = t_blocks.flash_attention(tq, tk, tv, q_chunk=4, kv_chunk=8, **kw)
    (out * torch.from_numpy(ct)).sum().backward()
    _, lse = t_ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                       return_lse=True, **kw)
    assert bool((out[:, 5:] == 0).all()) and bool((tq.grad[:, 5:] == 0).all())
    assert bool((lse[..., 5:] < -1e29).all())
    # dense reference by autograd, blind rows zeroed
    dq, dk, dv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    kr, vr = dk.repeat_interleave(2, dim=2), dv.repeat_interleave(2, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", dq, kr) / 4.0
    qpos, kpos = torch.arange(14, 22)[:, None], torch.arange(16)[None, :]
    mask = (qpos >= kpos) & (qpos - kpos < 4)
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1) * mask.any(-1)[:, None]
    want = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    (want * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    for g, w in ((tq.grad, dq.grad), (tk.grad, dk.grad), (tv.grad, dv.grad)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)


def test_chunked_softmax_xent_matches_the_reference():
    """T = 37 (ragged against chunks of 8, padded with target −1) with
    some targets −1: the mean NLL and the gradients wrt x and the head."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 37, 16)).astype(np.float32)
    head = (rng.standard_normal((16, 50)) * 0.3).astype(np.float32)
    tgt = rng.integers(0, 50, (2, 37)).astype(np.int32)
    tgt[0, ::5] = -1
    tgt[1, 30:] = -1
    (want, w_grads) = jax.value_and_grad(
        lambda a, h: j_blocks.chunked_softmax_xent(a, h, jnp.asarray(tgt), chunk=8),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    tx, th = (torch.from_numpy(a).requires_grad_(True) for a in (x, head))
    got = t_blocks.chunked_softmax_xent(tx, th, torch.from_numpy(tgt), chunk=8)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    for g, w in zip((tx.grad, th.grad), w_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    # every target ignored: 0, not a division by zero
    none = t_blocks.chunked_softmax_xent(tx, th, torch.full((2, 37), -1))
    assert float(none) == 0.0


# ---------------------------------------------------------------------------
# the recurrences' checkpointed gradients
# ---------------------------------------------------------------------------

def test_block_gradients_match(monkeypatch):
    """Twin of tests/test_ssd_block.py::test_block_gradients_match in the
    port alone: at S = 128 the gradient of Σ y² wrt x through the SSD block
    form (two chunks, each checkpointed) equals the one through the step
    form (SSD_CHUNK forced past S)."""
    _, cfg = configs("zamba2_7b")
    spec = cfg.ssm
    gen = torch.Generator().manual_seed(0)
    lp = t_ssm.mamba_init(gen, cfg, torch.float32, torch.device("cpu"))
    x0 = torch.randn((2, 128, cfg.d_model), generator=gen) * 0.5
    st0 = torch.zeros((2, spec.n_heads(cfg.d_model), spec.head_dim, spec.d_state))

    def grad_x():
        x = x0.clone().requires_grad_(True)
        y, _, _ = t_ssm.mamba_block(lp, x, cfg, st0, None)
        torch.sum(torch.square(y.to(torch.float32))).backward()
        return x.grad

    g_blk = grad_x()
    monkeypatch.setattr(t_ssm, "SSD_CHUNK", 10 ** 9)
    g_seq = grad_x()
    np.testing.assert_allclose(g_blk.numpy(), g_seq.numpy(), rtol=5e-3, atol=5e-3)


def test_wkv_chunked_gradients_match_the_flat_scan_and_the_reference():
    """`_wkv_scan` at S = 128 runs two checkpointed WKV_CHUNK chunks: its
    output and the gradients wrt r, k, v, w, u and the initial state equal
    the flat step loop's, and the reference's (its chunked scan under
    `jax.checkpoint`) in f32."""
    rng = np.random.default_rng(4)
    b, s, h, dh = 2, 128, 2, 64
    arrs = [rng.standard_normal((b, s, h, dh)).astype(np.float32) * 0.3 for _ in range(3)]
    w = rng.uniform(0.8, 0.99, (b, s, h, dh)).astype(np.float32)
    u = (rng.standard_normal((h, dh)) * 0.1).astype(np.float32)
    st = (rng.standard_normal((b, h, dh, dh)) * 0.1).astype(np.float32)
    ct = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    ct_st = rng.standard_normal((b, h, dh, dh)).astype(np.float32)
    inputs = arrs + [w, u, st]

    def port(chunked):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
        if chunked:
            out, state = t_rwkv6._wkv_scan(*ts)
        else:
            out, state = t_rwkv6._wkv_steps(*ts[:4], ts[4][None, :, :, None], ts[5],
                                            torch.float32)
        ((out * torch.from_numpy(ct)).sum() + (state * torch.from_numpy(ct_st)).sum()).backward()
        return out.detach(), [t.grad for t in ts]

    out_c, g_c = port(True)
    out_f, g_f = port(False)
    assert torch.equal(out_c, out_f)

    def j_loss(*a):
        out, state = j_rwkv6._wkv_scan(*a)
        return jnp.sum(out * ct) + jnp.sum(state * ct_st)

    w_grads = jax.grad(j_loss, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in inputs))
    for name, gc, gf, gw in zip(("r", "k", "v", "w", "u", "state0"), g_c, g_f, w_grads):
        np.testing.assert_allclose(gc.numpy(), gf.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(gc.numpy(), np.asarray(gw), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the train step against a reference step
# ---------------------------------------------------------------------------

def _reference_step(tcfg):
    """The reference's train step body (`train_step.make_train_step`'s
    `step`) from its own parts, jitted, without a mesh."""
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


STEP_CASES = {
    "smollm": dict(arch="smollm_135m", accum=1, batch=2),
    "smollm-accum2": dict(arch="smollm_135m", accum=2, batch=4),
    "hubert-dr": dict(arch="hubert_xlarge", accum=1, batch=2, dr=True),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_a_reference_step(case):
    """Two steps of `make_train_step` (f32 compute, lr 1e-3 after 1 warm-up
    step) from the reference's initial state, on the synthetic stream's
    batches, against the reference step: loss, grad_norm, lr and the aux
    terms each step, then every leaf of the state (params, AdamW m / v /
    step, the DR unit's B, the step).  `hubert-dr` runs the DR front-end
    (RP 32 → 16 → EASI 8) co-trained inside the step; `smollm-accum2`
    accumulates two micro-batches."""
    spec = STEP_CASES[case]
    jc, tc = configs(spec["arch"], "float32")
    if spec.get("dr"):
        jc = dataclasses.replace(jc, dr_frontend=JSpec(p=16, n=8))
        tc = dataclasses.replace(tc, dr_frontend=TSpec(p=16, n=8))
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    jcfg = j_ts.TrainConfig(arch=jc, opt=j_opt.AdamWConfig(**opt), grad_accum=spec["accum"])
    tcfg = t_ts.TrainConfig(arch=tc, opt=t_opt.AdamWConfig(**opt), grad_accum=spec["accum"])
    j_state = j_ts.init_state(jax.random.PRNGKey(0), jcfg)
    t_state = bridge.train_state_from_reference(np_tree(j_state), device="cpu")
    j_step, t_step = _reference_step(jcfg), t_ts.make_train_step(tcfg, execution=CPU_KERNEL)
    data = t_synthetic.TokenStreamConfig(vocab_size=jc.vocab_size, seq_len=16,
                                         global_batch=spec["batch"], seed=3)
    for i in range(2):
        batch = t_trainer.make_batch(tc, data, i)
        j_state, j_metrics = j_step(j_state, {k: jnp.asarray(v.numpy())
                                              for k, v in batch.items()})
        t_state, t_metrics = t_step(t_state, batch)
        assert set(t_metrics) == set(j_metrics)
        for name in j_metrics:
            np.testing.assert_allclose(float(t_metrics[name]), float(j_metrics[name]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name} at step {i}")
    got, want = _port_leaves(t_state), _ref_leaves(j_state)
    assert set(got) == set(want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        if want[path].dtype.kind in "iu":
            np.testing.assert_array_equal(got[path], want[path], err_msg=path)
        else:
            # by leaf: AdamW moves an element whose gradient is near zero by
            # up to lr on a last-bit difference of that gradient
            assert _rel(got[path], want[path]) <= GRAD_REL["float32"], path
    if spec.get("dr"):
        assert int(t_state.dr.steps) == 2 and not np.array_equal(
            bridge.to_array(t_state.dr.b), np.asarray(jax.device_get(j_ts.init_state(
                jax.random.PRNGKey(0), jcfg).dr.b)))


def test_train_step_refuses_what_needs_a_mesh():
    _, tc = configs("smollm_135m")
    with pytest.raises(NotImplementedError, match="A10"):
        t_ts.make_train_step(t_ts.TrainConfig(arch=tc), execution=CPU, mesh=object())
    with pytest.raises(NotImplementedError, match="A10"):
        t_ts.make_train_step(t_ts.TrainConfig(arch=tc, grad_compress=object()), execution=CPU)


def test_training_entry_points_without_a_card_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    _, tc = configs("smollm_135m")
    tcfg = t_ts.TrainConfig(arch=tc)
    calls = [lambda: t_ts.make_train_step(tcfg),
             lambda: t_ts.init_state(torch.Generator(), tcfg),
             lambda: t_trainer.train(t_trainer.TrainerConfig(train=tcfg, total_steps=1,
                                                             ckpt_dir=str(tmp_path))),
             lambda: t_launch.main(["--arch", "smollm_135m", "--smoke", "--steps", "1",
                                    "--ckpt-dir", str(tmp_path)])]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(NotImplementedError, match="A10"):
        t_launch.main(["--arch", "smollm_135m", "--smoke", "--multi-pod", "--device", "cpu"])


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (7, 1, 2), (123456, 3, 4)])
def test_synthetic_batches_equal_the_reference(step, shard, n_shards):
    cfg = dict(vocab_size=32000, seq_len=33, global_batch=8, seed=5)
    want = j_synthetic.token_batch(j_synthetic.TokenStreamConfig(**cfg), step, shard=shard,
                                   n_shards=n_shards)
    got = t_synthetic.token_batch(t_synthetic.TokenStreamConfig(**cfg), step, shard=shard,
                                  n_shards=n_shards)
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    assert int(got["step"]) == int(want["step"])
    w = j_synthetic.feature_batch(12, 20, step, seed=5, shard=shard, n_shards=n_shards)
    g = t_synthetic.feature_batch(12, 20, step, seed=5, shard=shard, n_shards=n_shards)
    assert g.dtype == torch.float32
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    stream = t_synthetic.stream(t_synthetic.TokenStreamConfig(**cfg), step, shard=shard,
                                n_shards=n_shards)
    np.testing.assert_array_equal(next(stream)["tokens"].numpy(), got["tokens"].numpy())


# ---------------------------------------------------------------------------
# checkpoints: twins of tests/test_fault_tolerance.py::TestCheckpointManager
# ---------------------------------------------------------------------------

class TestCheckpointManager:
    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        state = {"a": torch.arange(10, dtype=torch.float32), "b": {"c": torch.ones((3, 4))}}
        mgr.save(5, state)
        step, restored = mgr.restore({"a": torch.zeros(10), "b": {"c": torch.zeros((3, 4))}})
        assert step == 5
        for x, y in zip(t_opt.tree_leaves(state), t_opt.tree_leaves(restored)):
            assert torch.equal(x, y)
        # a 0-dim counter stays 0-dim
        mgr.save(6, {"step": torch.tensor(6, dtype=torch.int32)})
        assert mgr.restore({"step": torch.tensor(0, dtype=torch.int32)})[1]["step"].shape == ()

    def test_keep_n_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
        for s in (1, 2, 3, 4):
            mgr.save(s, {"x": torch.zeros((4,))})
        assert mgr.steps() == [3, 4]

    def test_corruption_quarantine(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        state = {"x": torch.arange(4, dtype=torch.float32)}
        mgr.save(1, state)
        mgr.save(2, state)
        with open(os.path.join(str(tmp_path), "step_00000002", "manifest.json"), "w") as f:
            f.write("{broken")
        step, _ = mgr.restore({"x": torch.zeros(4)})
        assert step == 1  # fell back
        assert any(n.endswith(".corrupt") for n in os.listdir(str(tmp_path)))

    def test_partial_tmp_cleaned(self, tmp_path):
        os.makedirs(os.path.join(str(tmp_path), "tmp_step_00000009"))
        CheckpointManager(str(tmp_path), async_save=False)
        assert not any(n.startswith("tmp_") for n in os.listdir(str(tmp_path)))

    def test_async_save_blocks_on_wait(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        mgr.save(7, {"x": torch.arange(1000, dtype=torch.float32)})
        mgr.wait()
        assert mgr.latest_step() == 7

    def test_manifest_records_leaf_hashes(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(1, {"x": torch.arange(64, dtype=torch.float32)})
        d = os.path.join(str(tmp_path), "step_00000001")
        with open(os.path.join(d, "manifest.json")) as f:
            entry = json.load(f)["leaves"][0]
        assert entry["sha256"] == leaf_hash(np.load(os.path.join(d, entry["file"])))

    def test_flipped_leaf_byte_quarantines_and_falls_back(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        good = {"x": torch.arange(64, dtype=torch.float32)}
        mgr.save(1, good)
        mgr.save(2, {"x": torch.arange(64, dtype=torch.float32) * 2.0})
        leaf = os.path.join(str(tmp_path), "step_00000002", "leaf_00000.npy")
        with open(leaf, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            b = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([b[0] ^ 0x01]))
        step, restored = mgr.restore({"x": torch.zeros(64)})
        assert step == 1
        assert "step_00000002.corrupt" in os.listdir(str(tmp_path))
        assert torch.equal(restored["x"], good["x"])

    def test_pre_hash_manifest_still_restores(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        state = {"x": torch.arange(8, dtype=torch.float32)}
        mgr.save(3, state)
        mpath = os.path.join(str(tmp_path), "step_00000003", "manifest.json")
        with open(mpath) as f:
            manifest = json.load(f)
        for entry in manifest["leaves"]:
            del entry["sha256"]
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        step, restored = mgr.restore({"x": torch.zeros(8)})
        assert step == 3 and torch.equal(restored["x"], state["x"])


def _dr_configs():
    jc, tc = configs("hubert_xlarge", "float32")
    return (j_ts.TrainConfig(arch=dataclasses.replace(jc, dr_frontend=JSpec(p=16, n=8))),
            t_ts.TrainConfig(arch=dataclasses.replace(tc, dr_frontend=TSpec(p=16, n=8))))


def test_train_state_bridge_round_trip():
    """`bridge.train_state_from_reference` then `train_state_to_numpy`
    gives back every leaf of a reference `TrainState` (with a DR unit),
    the counters int32 scalars on the host."""
    jcfg, _ = _dr_configs()
    j_state = j_ts.init_state(jax.random.PRNGKey(2), jcfg)
    t_state = bridge.train_state_from_reference(np_tree(j_state), device="cpu")
    assert isinstance(t_state, t_ts.TrainState)
    for counter in (t_state.step, t_state.opt.step, t_state.dr.steps):
        assert counter.dtype == torch.int32 and counter.shape == () and \
            counter.device.type == "cpu"
    _assert_equal_leaves(_port_leaves(bridge.train_state_to_numpy(t_state)),
                         _ref_leaves(j_state))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bridge.train_state_from_reference(np_tree(j_state))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A reference `TrainState` (hubert SMOKE with a DR front-end: params,
    AdamW state, the DR unit's R / B / steps) saved by the reference's
    manager restores into the port's own `init_state` layout, every leaf
    equal, the counters on the host."""
    jcfg, tcfg = _dr_configs()
    j_state = j_ts.init_state(jax.random.PRNGKey(7), jcfg)
    j_state = j_state._replace(step=jnp.int32(5), opt=j_state.opt._replace(step=jnp.int32(5)))
    JCheckpointManager(str(tmp_path), async_save=False).save(5, j_state)
    target = t_ts.init_state(torch.Generator().manual_seed(0), tcfg, execution=CPU)
    step, got = CheckpointManager(str(tmp_path)).restore(target)
    assert step == 5 and isinstance(got, t_ts.TrainState)
    assert int(got.step) == 5 and got.step.device.type == "cpu"
    _assert_equal_leaves(_port_leaves(got), _ref_leaves(j_state))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port's state after one train step, saved by the port's manager,
    restores through the reference's manager into the reference's
    `init_state` layout, every leaf equal."""
    jcfg, tcfg = _dr_configs()
    state = t_ts.init_state(torch.Generator().manual_seed(1), tcfg, execution=CPU)
    data = t_synthetic.TokenStreamConfig(vocab_size=tcfg.arch.vocab_size, seq_len=8,
                                         global_batch=2)
    state, _ = t_ts.make_train_step(tcfg, execution=CPU)(
        state, t_trainer.make_batch(tcfg.arch, data, 0))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    mgr.wait()
    target = j_ts.init_state(jax.random.PRNGKey(0), jcfg)
    step, got = JCheckpointManager(str(tmp_path)).restore(
        jax.tree.map(jnp.zeros_like, target))
    assert step == 1
    _assert_equal_leaves(_ref_leaves(got), _port_leaves(state))
    assert int(got.step) == 1 and int(got.dr.steps) == 1


# ---------------------------------------------------------------------------
# the trainer, the watchdog, the CLI
# ---------------------------------------------------------------------------

def _trainer_cfg(tmpdir, total_steps=6, ckpt_every=3):
    _, tc = configs("smollm_135m")
    tcfg = t_ts.TrainConfig(arch=tc, opt=t_opt.AdamWConfig(lr=1e-3), seed=0)
    return t_trainer.TrainerConfig(train=tcfg, total_steps=total_steps, ckpt_dir=str(tmpdir),
                                   ckpt_every=ckpt_every, log_every=100)


DATA = t_synthetic.TokenStreamConfig(vocab_size=256, seq_len=32, global_batch=4)


def test_interrupted_run_matches_uninterrupted(tmp_path):
    """Run 3 steps, then restart into a fresh state from the checkpoint and
    run to 6: the losses and every leaf equal the straight 6-step run's bit
    for bit (CPU).  A port-only property: the reference's twin
    (tests/test_fault_tolerance.py::TestResume) fails on its mesh."""
    quiet = dict(execution=CPU, data_cfg=DATA, log=lambda s: None)
    full = t_trainer.train(_trainer_cfg(tmp_path / "a"), **quiet)
    short = dataclasses.replace(_trainer_cfg(tmp_path / "b"), total_steps=3)
    first = t_trainer.train(short, **quiet)
    restored = CheckpointManager(str(tmp_path / "b")).restore(
        t_ts.init_state(torch.Generator().manual_seed(9), short.train, execution=CPU))[1]
    _assert_equal_leaves(_port_leaves(restored), _port_leaves(first["state"]))
    resumed = t_trainer.train(_trainer_cfg(tmp_path / "b"), **quiet)
    assert resumed["start_step"] == 3
    assert first["losses"] + resumed["losses"] == full["losses"]
    _assert_equal_leaves(_port_leaves(resumed["state"]), _port_leaves(full["state"]))


def test_loss_decreases(tmp_path):
    res = t_trainer.train(_trainer_cfg(tmp_path, total_steps=12, ckpt_every=20),
                          execution=CPU, data_cfg=DATA, log=lambda s: None)
    assert np.mean(res["losses"][-3:]) < np.mean(res["losses"][:3])


class TestWatchdog:
    def test_flags_outlier(self):
        wd = t_trainer.StragglerWatchdog(factor=3.0, min_steps=3)
        for i in range(6):
            assert not wd.observe(i, 0.1)
        assert wd.observe(6, 1.0)  # 10x EMA
        assert wd.events and wd.events[0][0] == 6

    def test_no_flag_on_gradual_drift(self):
        wd = t_trainer.StragglerWatchdog(factor=3.0, min_steps=3)
        t = 0.1
        for i in range(20):
            t *= 1.1
            assert not wd.observe(i, t)


def test_launch_train_smoke_on_the_cpu(tmp_path, capsys):
    """`python -m repro_torch.launch.train --arch smollm_135m --smoke
    --steps 3 --device cpu`: three steps, a checkpoint at the end."""
    res = t_launch.main(["--arch", "smollm_135m", "--smoke", "--steps", "3", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path), "--seq-len", "16", "--global-batch", "2"])
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    assert CheckpointManager(str(tmp_path)).steps() == [3]
    assert "done: final loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch_id", j_registry.ARCH_IDS)
def test_exact_param_counts_match_the_reference(arch_id):
    """(total, active) from the port's own init on fake tensors, at full
    size, against the reference's count from `jax.eval_shape`."""
    assert t_api.exact_param_counts(t_registry.get(arch_id)) == \
        j_api.exact_param_counts(j_registry.get(arch_id))
