"""The port's flash attention on CPU tensors (the kernel wrapper's plain
version, and the chunked plain path of `models.blocks`) against the JAX
package's Pallas kernel in interpret mode and its XLA flash path.

The CUDA kernel itself runs only on the card; `chip_smoke.py` holds it
against the same plain version there.  Rows that see no key are compared
with JAX nowhere: both JAX functions give such rows a value that depends
on their chunking, the port gives them 0."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention_fwd
from repro.models import blocks as j_blocks
from repro_torch import bridge
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import ops
from repro_torch.models import blocks as t_blocks

# (b, sq, skv, hq, hkv, dh, causal, window, cq, ck): tests/test_flash_kernel.py
KERNEL_CASES = [
    (1, 128, 128, 4, 2, 64, True, None, 64, 128),
    (2, 96, 96, 4, 4, 32, True, None, 32, 128),     # ragged + MHA
    (1, 256, 256, 8, 2, 128, True, 64, 128, 128),   # SWA + GQA 4
    (2, 64, 64, 9, 3, 64, False, None, 64, 128),    # encoder, odd heads
    (1, 1, 160, 4, 1, 64, True, None, 8, 128),      # decode-like (q=1, MQA)
    (1, 70, 133, 8, 2, 120, True, 48, 32, 128),     # dh 120, odd skv, SWA, q_offset
    (1, 192, 192, 8, 1, 72, True, 40, 64, 64),      # dh 72, GQA 8, window hides tiles
    (1, 160, 160, 4, 2, 120, True, 24, 32, 64),     # dh 120, window hides tiles
    (1, 1, 200, 8, 1, 120, True, 64, 8, 64),        # Sq = 1 at q_offset 199, GQA 8, SWA
    (2, 1, 75, 4, 4, 72, True, None, 8, 64),        # Sq = 1 at q_offset 74, dh 72
]
# (b, s, hq, hkv, dh, causal, window, qc, kc): tests/test_blocks.py
BLOCK_CASES = [
    (2, 64, 4, 2, 16, True, None, 16, 16),
    (1, 100, 6, 2, 8, True, None, 32, 16),   # ragged padding
    (3, 48, 4, 4, 16, False, None, 16, 32),  # encoder
    (2, 96, 8, 2, 16, True, 24, 32, 32),     # SWA
    (2, 32, 9, 3, 8, True, None, 32, 32),    # single chunk, odd heads
    (1, 80, 4, 1, 32, True, 16, 16, 16),     # MQA + window
]
DTYPES = {"f32": (jnp.float32, 2e-5), "bf16": (jnp.bfloat16, 2e-2)}


def _qkv(seed, b, sq, skv, hq, hkv, dh, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh))]
    js = [jnp.asarray(a, dtype) for a in arrs]
    return js, [bridge.to_tensor(np.asarray(j), device="cpu") for j in js]


def _close(got_t, want_j, tol):
    np.testing.assert_allclose(bridge.to_array(got_t), np.asarray(want_j, np.float32),
                               rtol=tol, atol=tol)


def _port_routes(qt, kt, vt, *, causal, window, q_offset, cq, ck):
    """The kernel wrapper (its plain version on CPU), the ops entry point,
    and the chunked plain path at the reference test's chunks."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    return {
        "wrapper": t_flash.flash_attention(qt, kt, vt, **kw),
        "ops": ops.flash_attention(qt, kt, vt, **kw),
        "blocks": t_blocks.flash_attention(qt, kt, vt, q_chunk=cq, kv_chunk=ck, **kw),
    }


@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,causal,window,cq,ck", KERNEL_CASES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_matches_pallas_kernel_and_xla_flash(b, sq, skv, hq, hkv, dh, causal, window, cq,
                                             ck, dt):
    dtype, tol = DTYPES[dt]
    (qj, kj, vj), (qt, kt, vt) = _qkv(sq * 7 + skv, b, sq, skv, hq, hkv, dh, dtype)
    q_offset = skv - sq if causal and sq < skv else 0
    want_kernel = flash_attention_fwd(qj, kj, vj, causal=causal, window=window, q_chunk=cq,
                                      kv_chunk=ck, q_offset=q_offset, interpret=True)
    want_xla = j_blocks.flash_attention(qj, kj, vj, causal=causal, window=window,
                                        q_chunk=cq, kv_chunk=ck, q_offset=q_offset)
    for route, got in _port_routes(qt, kt, vt, causal=causal, window=window,
                                   q_offset=q_offset, cq=cq, ck=ck).items():
        assert got.dtype == qt.dtype and tuple(got.shape) == (b, sq, hq, dh), route
        _close(got, want_kernel, tol)
        _close(got, want_xla, tol)


@pytest.mark.parametrize("b,s,hq,hkv,dh,causal,window,qc,kc", BLOCK_CASES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_matches_xla_flash_at_block_cases(b, s, hq, hkv, dh, causal, window, qc, kc, dt):
    dtype, tol = DTYPES[dt]
    (qj, kj, vj), (qt, kt, vt) = _qkv(b * 100 + s, b, s, s, hq, hkv, dh, dtype)
    want = j_blocks.flash_attention(qj, kj, vj, causal=causal, window=window,
                                    q_chunk=qc, kv_chunk=kc)
    for route, got in _port_routes(qt, kt, vt, causal=causal, window=window, q_offset=0,
                                   cq=qc, ck=kc).items():
        assert got.dtype == qt.dtype, route
        _close(got, want, tol)


def test_block_shape_invariance():
    (qj, kj, vj), (qt, kt, vt) = _qkv(3, 1, 192, 192, 4, 2, 64, jnp.float32)
    outs = [t_blocks.flash_attention(qt, kt, vt, q_chunk=cq, kv_chunk=ck)
            for cq, ck in ((32, 128), (64, 128), (192, 128), (7, 5))]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=1e-5, atol=1e-5)
    want = flash_attention_fwd(qj, kj, vj, q_chunk=64, kv_chunk=128, interpret=True)
    _close(outs[0], want, 2e-5)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_rows_that_see_no_key_are_zero(dt):
    """q at positions 14..21, 16 keys, causal, window 4: rows at 14..18 see
    keys, rows at 19..21 see none (their keys would lie past skv)."""
    dtype, tol = DTYPES[dt]
    (qj, kj, vj), (qt, kt, vt) = _qkv(11, 2, 8, 16, 4, 2, 32, dtype)
    kw = dict(causal=True, window=4, q_offset=14)
    want = flash_attention_fwd(qj, kj, vj, q_chunk=8, kv_chunk=128, interpret=True, **kw)
    for route, got in _port_routes(qt, kt, vt, cq=3, ck=5, **kw).items():
        assert not bool(got[:, 5:].to(torch.float32).any()), route
        _close(got[:, :5], want[:, :5], tol)
    # every row blind: q at 100, keys 0..15, window 4
    none = t_flash.flash_attention(qt, kt, vt, causal=True, window=4, q_offset=100)
    assert not bool(none.to(torch.float32).any())
    assert not bool(t_blocks.flash_attention(qt, kt, vt, window=4, q_offset=100, q_chunk=2,
                                             kv_chunk=3).to(torch.float32).any())


def test_reference_gives_blind_rows_a_chunk_dependent_value():
    """Why the port does not copy the reference on rows that see no key:
    q at 100 over 16 keys, causal, window 4.  The Pallas kernel pads the
    keys to its 128-wide block and returns sum(v)/128; the XLA path
    returns mean(v) over its chunk; the port returns 0."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(13, 1, 4, 16, 2, 1, 16, jnp.float32)
    kw = dict(causal=True, window=4, q_offset=100)
    v_sum = np.asarray(vj, np.float32).sum(axis=1)                      # (b, hkv, dh)
    pallas = np.asarray(flash_attention_fwd(qj, kj, vj, interpret=True, **kw))
    xla = np.asarray(j_blocks.flash_attention(qj, kj, vj, q_chunk=4, kv_chunk=16, **kw))
    for row in range(4):
        for h in range(2):
            np.testing.assert_allclose(pallas[:, row, h], v_sum[:, 0] / 128, rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(xla[:, row, h], v_sum[:, 0] / 16, rtol=1e-5,
                                       atol=1e-6)
    assert not bool(t_flash.flash_attention(qt, kt, vt, **kw).any())


def test_wrapper_refuses_a_device_it_cannot_run_on():
    q = torch.zeros((1, 4, 2, 8), device="meta")
    k = torch.zeros((1, 4, 1, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        t_flash.flash_attention(q, k, k)
