"""The attention backward's kernel wrapper (`kernels.flash_attention.
flash_attention_bwd`) and `FlashAttentionFn`'s choice of backward.

On the CPU: the wrapper's plain path is `ref.flash_attention_bwd_ref` bit
for bit, its fake-tensor branch allocates the three gradients and reports
its work, and `FlashAttentionFn` sends bf16 inputs with `backend="kernel"`
through the wrapper and everything else through the plain chunked
backward.  On the card (marked `cuda`, skipped without one; run there with
`python -m pytest -m cuda tests/test_torch_flash_bwd.py`): the CUDA kernel
against `flash_attention_bwd_ref` in bf16, within FLASH_GRAD_REL_NORM of
`chip_smoke.py` (the relative norm of each gradient), and two calls equal
bit for bit.  This file imports nothing of JAX, so it runs on the card's
machine as it is."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as t_kernels
from repro_torch.kernels import fake, ops
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels.ref import flash_attention_bwd_ref
from repro_torch.models import blocks

# the relative norm of kernel - plain over each of dq, dk, dv in bf16: both
# round p and ds to bf16 before each product and differ only in the order of
# their f32 sums and in exp's last bits (chip_smoke.py's FLASH_GRAD_REL_NORM)
REL_NORM = 1e-2

# (b, sq, skv, hq, hkv, dh, causal, window, q_offset) on the CPU
CPU_CASES = [
    (2, 40, 40, 4, 2, 16, True, None, 0),
    (1, 33, 70, 6, 3, 24, True, 20, 37),      # ragged Sq / Skv at a q_offset, window
    (2, 24, 30, 4, 4, 13, False, None, 0),    # non-causal, Dh not a multiple of 8
    (1, 8, 16, 4, 1, 16, True, 4, 14),        # rows 5..7 see no key
]

# on the card: hubert-xlarge's train shape (non-causal, 16 / 16 heads of 80);
# h2o-danube-3-4b's geometry (GQA 32 / 8, Dh 120, causal), with and without
# its window at a q_offset past it; a window that hides whole tiles; ragged
# Sq / Skv at a q_offset; Dh 13 (element-by-element loads) and 64
# (internvl2-1b's GQA 7); Dh 112 (zamba2's shared block, an odd number of
# 16-wide k-steps) and Dh 40 (a 48-wide tile, GQA 4)
CARD_CASES = [
    (8, 1024, 1024, 16, 16, 80, False, None, 0),
    (1, 2048, 2048, 32, 8, 120, True, None, 0),
    (1, 600, 5001, 32, 8, 120, True, 4096, 4401),
    (2, 700, 700, 8, 2, 64, True, 150, 0),
    (2, 77, 300, 4, 2, 64, True, None, 223),
    (1, 100, 130, 6, 3, 72, False, None, 0),
    (1, 129, 190, 4, 4, 13, True, None, 61),
    (2, 333, 333, 14, 2, 64, True, None, 0),
    (1, 512, 512, 32, 32, 112, True, 256, 0),
    (2, 100, 100, 4, 1, 40, False, None, 0),
]


def _inputs(b, sq, skv, hq, hkv, dh, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype).to(device)
            for s in ((b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh), (b, sq, hq, dh))]


def _forward(q, k, v, **kw):
    return t_flash.flash_attention(q, k, v, return_lse=True, **kw)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernel runs only there")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,causal,window,q_offset", CPU_CASES)
def test_the_plain_path_is_the_reference_bit_for_bit(b, sq, skv, hq, hkv, dh, causal, window,
                                                     q_offset, dtype):
    q, k, v, dout = _inputs(b, sq, skv, hq, hkv, dh, dtype, "cpu")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = _forward(q, k, v, **kw)
    before = t_kernels.launch_counts()
    got = ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    assert t_kernels.launch_counts() == before
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("device", ["cuda:0", "meta"])
def test_a_fake_tensor_gets_the_gradients_shapes_and_reports_the_work(device):
    from torch._subclasses.fake_tensor import FakeTensorMode

    before = t_kernels.launch_counts()
    b, sq, skv, hq, hkv, dh = 2, 9, 12, 4, 2, 16
    with FakeTensorMode(allow_non_fake_inputs=True), fake.recording() as work:
        dev = torch.device(device)
        q, k, v, dout = (torch.empty(s, dtype=torch.bfloat16, device=dev)
                         for s in ((b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh),
                                   (b, sq, hq, dh)))
        out = torch.empty_like(q)
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
        grads = t_flash.flash_attention_bwd(q, k, v, out, lse, dout, causal=True, q_offset=3)
        for g, like in zip(grads, (q, k, v)):
            assert fake.is_fake(g) and g.device == dev
            assert (g.shape, g.dtype) == (like.shape, torch.bfloat16)
    assert t_kernels.launch_counts() == before
    assert work.calls == {"flash_attention_bwd": 1}
    pairs = sum(min(skv, 3 + r + 1) for r in range(sq))                  # causal at q_offset 3
    assert work.flops["flash_attention_bwd"] == 14.0 * b * hq * dh * pairs
    el = 2
    assert work.bytes["flash_attention_bwd"] == (
        el * (4 * b * sq * hq * dh + 4 * b * skv * hkv * dh) + 4 * b * hq * sq)


@pytest.mark.parametrize("backend,dtype,kernel", [
    ("kernel", torch.bfloat16, True), ("kernel", torch.float32, False),
    ("torch", torch.bfloat16, False)])
def test_flash_attention_fn_takes_the_kernel_backward_for_bf16(monkeypatch, backend, dtype,
                                                              kernel):
    """backend="kernel" with bf16 inputs goes through `ops.flash_attention_bwd`
    (here its plain version); f32 and backend="torch" take the plain chunked
    backward over the config's chunks, which gives the same gradients."""
    calls = []
    wrapped = ops.flash_attention_bwd

    def spy(*a, **kw):
        calls.append(kw)
        return wrapped(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention_bwd", spy)
    base = _inputs(2, 48, 48, 4, 2, 16, dtype, "cpu", seed=5)
    grads = {}
    for chunks in ((16, 32), (1024, 1024)):
        q, k, v = (t.clone().requires_grad_(True) for t in base[:3])
        out = blocks.flash_attention(q, k, v, causal=True, window=20, q_chunk=chunks[0],
                                     kv_chunk=chunks[1], backend=backend)
        out.backward(base[3])
        grads[chunks] = (q.grad, k.grad, v.grad)
    assert len(calls) == (2 if kernel else 0)
    assert all(c == dict(causal=True, window=20, q_offset=0) for c in calls)
    # the kernel's plain path runs the reference at its default chunks
    # whatever the config's; the plain path here follows them
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)
    for g, w in zip(grads[(16, 32)], grads[(1024, 1024)]):
        if kernel:
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, **tol)


def test_the_wrapper_refuses_a_device_it_cannot_run_on():
    q = torch.zeros((1, 4, 2, 8), device="meta")
    k = torch.zeros((1, 4, 1, 8), device="meta")
    lse = torch.zeros((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        t_flash.flash_attention_bwd(q, k, k, q, lse, q)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _rel_norm(got, want):
    got, want = got.to(torch.float32), want.to(torch.float32)
    return float((got - want).norm() / want.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,causal,window,q_offset", CARD_CASES)
def test_the_kernel_matches_the_reference_and_repeats_its_bits(card, b, sq, skv, hq, hkv, dh,
                                                               causal, window, q_offset):
    q, k, v, dout = _inputs(b, sq, skv, hq, hkv, dh, torch.bfloat16, card, seed=sq + dh)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = _forward(q, k, v, **kw)
    before = t_flash.bwd_launches
    got = t_flash.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = t_flash.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert t_flash.bwd_launches - before == 4
    want = flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert torch.equal(g, g2), f"{name}: two calls differ"
        assert bool(torch.isfinite(g).all()), name
        assert _rel_norm(g, w) <= REL_NORM, (name, _rel_norm(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [120, 72])
def test_rows_that_see_no_key_get_no_gradient(card, dh):
    """q at 14..21 over 16 keys, causal, window 4: rows 5..7 see no key; at
    q_offset 100 every row is blind, so dq, dk and dv are all 0."""
    q, k, v, dout = _inputs(2, 8, 16, 4, 2, dh, torch.bfloat16, card, seed=dh)
    kw = dict(causal=True, window=4, q_offset=14)
    out, lse = _forward(q, k, v, **kw)
    got = t_flash.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    assert not bool(got[0][:, 5:].to(torch.float32).any())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_norm(g, w) <= REL_NORM, (name, _rel_norm(g, w))
    kw = dict(causal=True, window=4, q_offset=100)
    out, lse = _forward(q, k, v, **kw)
    for g in t_flash.flash_attention_bwd(q, k, v, out, lse, dout, **kw):
        assert not bool(g.to(torch.float32).any())


@pytest.mark.cuda
def test_an_unaligned_pointer_loads_element_by_element(card):
    """q, k, v, dout 2 bytes past a 16-byte boundary: the kernel cannot use
    16-byte copies and loads element by element, to the same result."""
    b, sq, skv, hq, hkv, dh = 1, 200, 200, 8, 2, 64
    aligned = _inputs(b, sq, skv, hq, hkv, dh, torch.bfloat16, card, seed=3)

    def shifted(t):
        base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = base[1:].view(t.shape)
        out.copy_(t)
        return out

    q, k, v, dout = map(shifted, aligned)
    assert q.data_ptr() % 16 != 0
    out, lse = _forward(*aligned[:3])
    want = t_flash.flash_attention_bwd(*aligned[:3], out, lse, aligned[3])
    got = t_flash.flash_attention_bwd(q, k, v, out, lse, dout)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_the_kernel_takes_bf16_only(card):
    q, k, v, dout = _inputs(1, 16, 16, 2, 2, 16, torch.float32, card)
    out, lse = _forward(q, k, v)
    with pytest.raises(TypeError, match="bfloat16"):
        t_flash.flash_attention_bwd(q, k, v, out, lse, dout)
