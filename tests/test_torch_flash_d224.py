"""B4's forward at Dh 224 with a caller's scale (Zamba2's shared block: 32
heads of 224 on the 7168-wide concat, scores scaled by (224 / 2)^-1/2).

On the CPU: the wrapper's and `blocks.flash_attention`'s plain path honour
`scale` (equal to an explicit softmax in f64, and the default scale bit for
bit where none is given), and the training path's plain backward takes it
too.  On the card (marked `cuda`, skipped without one; run there with
`python -m pytest -m cuda tests/test_torch_flash_d224.py`): the D 224
kernel against `flash_attention_ref` in bf16 within chip_smoke.py's
FLASH_REL_NORM over every (batch, head), its lse beside the reference's,
two calls equal bit for bit, at Zamba2's prefill (1, 4096, 32 / 32) and
ragged, GQA, windowed and unaligned-width cases.  This file imports nothing
of JAX, so it runs on the card's machine as it is."""

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref
from repro_torch.models import blocks

# chip_smoke.py's FLASH_REL_NORM: bf16 kernel against the plain version, the
# relative norm over a (batch, head); both round p to bf16 before p·v and
# differ in the order of their f32 sums and in exp's last bits
REL_NORM = 5e-3
ZAMBA_SCALE = 1.0 / math.sqrt(112)

# (b, sq, skv, hq, hkv, dh, window, q_offset) on the card, causal
CARD_CASES = [
    (1, 4096, 4096, 32, 32, 224, None, 0),    # Zamba2-7B's prefill
    (2, 1000, 1000, 4, 2, 224, None, 0),      # ragged, GQA
    (1, 77, 300, 6, 3, 224, 64, 223),         # decode-like rows at an offset, a window
    (1, 333, 333, 4, 4, 196, None, 0),        # Dh not a multiple of 8: element loads
    (2, 200, 200, 2, 1, 160, None, 0),        # Dh 160 in the 224 tile
]


def _inputs(b, sq, skv, hq, hkv, dh, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype).to(device)
            for s in ((b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh))]


def _explicit(q, k, v, scale, causal, window=None, q_offset=0):
    """Softmax attention in f64, every score written out."""
    b, sq, hq, dh = q.shape
    g = hq // k.shape[2]
    kk = k.double().repeat_interleave(g, dim=2)
    vv = v.double().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kk) * scale
    qp = torch.arange(sq)[:, None] + q_offset
    kp = torch.arange(k.shape[1])[None, :]
    hide = (kp > qp) if causal else torch.zeros_like(qp > kp)
    if window is not None:
        hide = hide | (qp - kp >= window)
    p = torch.softmax(s.masked_fill(hide, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv)


@pytest.mark.parametrize("scale", [None, ZAMBA_SCALE, 0.3])
@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0), (True, 5, 9),
                                                    (False, None, 0)])
def test_the_plain_path_honours_scale(scale, causal, window, q_offset):
    q, k, v = _inputs(2, 21, 30, 4, 2, 24, torch.float32, "cpu", seed=3)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = t_flash.flash_attention(q, k, v, scale=scale, **kw)
    want = _explicit(q, k, v, 1.0 / math.sqrt(24) if scale is None else scale, **kw)
    assert torch.allclose(got.double(), want, rtol=1e-5, atol=1e-6)
    via_blocks = blocks.flash_attention(q, k, v, backend="kernel", q_chunk=8, kv_chunk=8,
                                        scale=scale, **kw)
    assert torch.allclose(via_blocks, got, rtol=1e-5, atol=1e-6)
    if scale is None:
        assert torch.equal(got, flash_attention_ref(q, k, v, **kw))


def test_the_training_path_takes_the_scale_into_its_backward():
    q, k, v = (t.requires_grad_() for t in _inputs(1, 16, 16, 2, 2, 8, torch.float32, "cpu",
                                                   seed=5))
    out = blocks.flash_attention(q, k, v, causal=True, q_chunk=4, kv_chunk=4, scale=0.2)
    dout = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), dout)
    q2, k2, v2 = (t.detach().double().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(_explicit(q2, k2, v2, 0.2, True), (q2, k2, v2), dout.double())
    for g, w in zip(got, want):
        assert torch.allclose(g.double(), w, rtol=1e-4, atol=1e-6)
    # and the plain backward itself, given the forward's lse
    o, lse = flash_attention_ref(q.detach(), k.detach(), v.detach(), causal=True,
                                 return_lse=True, scale=0.2)
    plain = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o, lse, dout,
                                    causal=True, scale=0.2)
    for g, w in zip(plain, want):
        assert torch.allclose(g.double(), w, rtol=1e-4, atol=1e-6)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the D 224 kernel runs only there")
    return torch.device("cuda", 0)


def _rel_by_head(got, want):
    """The largest relative norm over (batch, head) of got − want."""
    d = (got.float() - want.float()).permute(0, 2, 1, 3).flatten(2)
    w = want.float().permute(0, 2, 1, 3).flatten(2)
    return float((d.norm(dim=-1) / w.norm(dim=-1).clamp(min=1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,window,q_offset", CARD_CASES)
def test_the_d224_kernel_matches_the_reference(card, b, sq, skv, hq, hkv, dh, window, q_offset):
    q, k, v = _inputs(b, sq, skv, hq, hkv, dh, torch.bfloat16, card, seed=sq + dh)
    kw = dict(causal=True, window=window, q_offset=q_offset, scale=ZAMBA_SCALE)
    before = t_flash.launches
    out, lse = t_flash.flash_attention(q, k, v, return_lse=True, **kw)
    again = t_flash.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert t_flash.launches - before == 2
    want, want_lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    assert torch.equal(out, again), "two calls differ"
    assert bool(torch.isfinite(out).all())
    assert _rel_by_head(out, want) <= REL_NORM, _rel_by_head(out, want)
    seen = want_lse > -1e29                      # rows that see some key
    assert torch.allclose(lse[seen], want_lse[seen], rtol=0, atol=2e-2)


@pytest.mark.cuda
def test_the_default_scale_is_unchanged_at_the_narrower_tiles(card):
    """Dh 64 and 128 keep 1/sqrt(Dh) where no scale is given, and a given
    scale reaches them too."""
    for dh in (64, 120):
        q, k, v = _inputs(1, 256, 256, 4, 2, dh, torch.bfloat16, card, seed=dh)
        for scale in (None, 0.05):
            got = t_flash.flash_attention(q, k, v, causal=True, scale=scale)
            want = flash_attention_ref(q, k, v, causal=True, scale=scale)
            assert _rel_by_head(got, want) <= REL_NORM, (dh, scale)
