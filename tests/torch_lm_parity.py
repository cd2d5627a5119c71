"""Shared helpers of the port's LM parity tests (`test_torch_lm*.py`,
`test_torch_moe.py`): one request served by the JAX package's `api` and by
the port's on the same inputs, step by step.

Parameters are drawn by JAX and carried across with
`bridge.params_from_reference`; prompts, modality features and
teacher-forced decode tokens come from numpy with a seed.  The reference
runs `api.prefill` / `api.decode_step` directly, without a mesh (jitted in
f32, op by op in bf16).  Import after `pytest.importorskip("torch")`."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as j_registry
from repro.models import api as j_api
from repro_torch import bridge
from repro_torch.configs import registry as t_registry
from repro_torch.core.execution import Execution
from repro_torch.models import api as t_api

CPU = Execution(device="cpu")
CPU_KERNEL = Execution(backend="kernel", device="cpu")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# f32 recurrent states that sum products of compute-dtype values over the
# steps (RWKV-6's WKV matrices, Mamba-2's SSD states).  In bf16 a one-ulp
# difference in a bf16 k or v (the summation order of the product that
# made it, which neither package fixes) moves such a sum by |k v|·2⁻⁸, up
# to 3e-2 where |k v| ≈ 6, on elements that cancel to near zero; their bf16
# tolerance is taken relative to the leaf's largest magnitude.
STATE_SUMS = ("wkv", "ssm")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(got_t, want_j, tol, what=""):
    np.testing.assert_allclose(bridge.to_array(got_t), np.asarray(want_j, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def configs(arch_id, compute_dtype=None, **changes):
    """(reference SMOKE config, the port's), each with `changes` applied."""
    jc, tc = j_registry.get_smoke(arch_id), t_registry.get_smoke(arch_id)
    if compute_dtype is not None:
        changes["compute_dtype"] = compute_dtype
    return dataclasses.replace(jc, **changes), dataclasses.replace(tc, **changes)


def request(cfg, *, batch=2, decode_steps=6, seed=5, prompt=None):
    """(numpy prefill batch, teacher-forced decode tokens (B, steps), cache
    size) for `cfg`: tokens, audio frames in place of the tokens, or vision
    patches before them.  The prompt is `prompt` tokens long if given, else
    12, and under SWA (window 16) 20: longer than the window and not a
    multiple of it."""
    rng = np.random.default_rng(seed)
    if prompt is None:
        prompt = 20 if cfg.sliding_window else 12
    toks = rng.integers(0, cfg.vocab_size, (batch, prompt + decode_steps), dtype=np.int32)
    feats = lambda s: rng.standard_normal((batch, s, cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "audio":
        inputs, n_prefix = {"frames": feats(prompt)}, 0
    elif cfg.frontend == "vision":
        inputs, n_prefix = {"patches": feats(cfg.frontend_seq), "tokens": toks[:, :prompt]}, \
            cfg.frontend_seq
    else:
        inputs, n_prefix = {"tokens": toks[:, :prompt]}, 0
    cache_size = 32 if cfg.sliding_window else n_prefix + prompt + decode_steps
    return inputs, toks[:, prompt:], cache_size


def serve_case(jc, tc, compute_dtype, execution, *, batch=2, decode_steps=6, front=None,
               kv_rp_r=None, prompt=None):
    """Prefill + `decode_steps` teacher-forced decode steps through both
    packages; logits and every leaf of the cache compared by name after
    every step (`k` / `v`, the recurrent families' `wkv`, `shift_t`,
    `shift_c`, `ssm`, `conv`; the counters `len` / `pos` as integers).

    `front`: (reference batch -> batch, port batch -> batch), applied to
    the prefill batch before prefill (the DR front-end); the features they
    give are compared too.  `kv_rp_r`: the explicit key sketch the port's
    steps take (the reference draws its own).  `prompt`: the prompt's
    length (`request`'s default otherwise)."""
    tol = TOL[compute_dtype]
    inputs, forced, cache_size = request(jc, batch=batch, decode_steps=decode_steps,
                                         prompt=prompt)
    params = j_api.init_params(jax.random.PRNGKey(3), jc)
    tparams = bridge.params_from_reference(np_tree(params), device="cpu")
    j_batch = {k: jnp.asarray(v) for k, v in inputs.items()}
    t_batch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    if front is not None:
        j_batch, t_batch = front[0](j_batch), front[1](t_batch)
        for key in j_batch:
            close(t_batch[key], j_batch[key], TOL["float32"], f"front-end {key}")
    # In bf16 the reference runs op by op: under jit, XLA keeps fused bf16
    # elementwise results in f32 where its fusion decides to, so the jitted
    # reference's rounding points move with the fusion; op by op every op
    # rounds once, as the port's do.
    op_by_op = compute_dtype == "bfloat16"
    wrap = (lambda f: f) if op_by_op else jax.jit
    j_prefill = wrap(lambda p, b: j_api.prefill(p, b, jc, cache_size))
    j_decode = wrap(lambda p, t, c: j_api.decode_step(p, t, c, jc))
    kw = dict(execution=execution, kv_rp_r=kv_rp_r)

    def check(step, got, want):
        logits, cache = got
        w_logits, w_cache = want
        assert logits.dtype == torch.float32
        close(logits, w_logits, tol, f"logits at {step}")
        assert set(cache) == set(w_cache), (step, sorted(cache), sorted(w_cache))
        for name in sorted(w_cache):
            if name in ("len", "pos"):
                assert int(cache[name]) == int(w_cache[name]), (step, name)
            else:
                assert cache[name].shape == w_cache[name].shape, (step, name)
                scale = 1.0
                if compute_dtype == "bfloat16" and name in STATE_SUMS:
                    scale = max(1.0, float(np.abs(np.asarray(w_cache[name])).max()))
                np.testing.assert_allclose(bridge.to_array(cache[name]),
                                           np.asarray(w_cache[name], np.float32), rtol=tol,
                                           atol=tol * scale, err_msg=f"cache {name} at {step}")

    with (jax.disable_jit() if op_by_op else contextlib.nullcontext()):
        want = j_prefill(params, j_batch)
        got = t_api.prefill(tparams, t_batch, tc, cache_size, **kw)
        check("prefill", got, want)
        for i in range(decode_steps):
            want = j_decode(params, jnp.asarray(forced[:, i]), want[1])
            got = t_api.decode_step(tparams, torch.from_numpy(forced[:, i]), got[1], tc, **kw)
            check(f"decode {i}", got, want)
