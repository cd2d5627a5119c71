"""The yardstick's counts against hand counts at the cells' own shapes."""

import pytest

pytest.importorskip("torch")

from portbench import arch, flops
from portbench.tests import smoke


def _arch(name):
    return arch.sizes(arch.read(smoke.ROOT / "portbench" / "configs" / f"{name}.json")["arch"])


def test_hubert_train_step():
    a = _arch("hubert-xlarge-dr")
    # a layer: q, k, v, o 4 · 1280², the published two-matrix MLP 2 · 1280 · 5120
    per_layer = 4 * 1280 * 1280 + 2 * 1280 * 5120
    n = 48 * per_layer + 1280 * 512 + 128 * 1280
    attn = 4 * 8 * 1024 * 1024 * 16 * 80 * 48
    assert flops.train_flops(a, 8, 1024) == pytest.approx(6 * n * 8192 + 3 * attn, rel=1e-12)
    assert flops.train_flops(a, 8, 1024) == pytest.approx(52.6e12, rel=0.01)


def test_internvl_prefill_request():
    a = _arch("internvl2-1b-dr")
    per_layer = 2 * 896 * 896 + 2 * 896 * 128 + 3 * 896 * 4864
    dense = 2 * 24 * per_layer * 16 * 512
    head = 2 * 896 * 151808 * 16
    proj = 2 * 256 * 896 * 16 * 256
    attn = 4 * 16 * (512 * 513 / 2) * 14 * 64 * 24
    assert flops.prefill_flops(a, 16, 512, 256) == pytest.approx(dense + head + proj + attn,
                                                                 rel=1e-12)
    assert flops.prefill_flops(a, 16, 512, 256) == pytest.approx(6.05e12, rel=0.02)


def test_hubert_encode_request():
    a = _arch("hubert-xlarge-dr")
    per_layer = 4 * 1280 * 1280 + 2 * 1280 * 5120
    body = 48 * per_layer + 128 * 1280
    attn = 4 * 8 * 1024 * 1024 * 16 * 80 * 48
    head = 1280 * 512 * 8                # the head on each clip's last position only
    f = flops.prefill_flops(a, 8, 1024, 1024)
    assert f == pytest.approx(2 * body * 8192 + 2 * head + attn, rel=1e-12)
    assert f == pytest.approx(17.5e12, rel=0.01)


def test_kernel_bounds():
    a = _arch("hubert-xlarge-dr")
    # B4 in training: 4 · 2 · 1024² · 16 · 80 operations, bf16 q k v o and f32 lse
    ops = 4 * 2 * 1024 * 1024 * 16 * 80
    nbytes = 2 * (4 * 2 * 1024 * 1280) + 4 * 2 * 1024 * 16
    want = max(ops / 989e12, nbytes / 3.35e12)
    assert flops.flash_bound_s(a, 2, 1024, lse=True) == pytest.approx(want, rel=1e-12)
    assert ops / 989e12 > nbytes / 3.35e12
    # B3 at training's rows: bytes bound, x and y in f32, R in int8
    b3 = (4 * 2048 * 512 + 256 * 512 + 4 * 2048 * 256) / 3.35e12
    assert flops.ternary_matmul_bound_s(2048, 512, 256) == pytest.approx(b3, rel=1e-12)
    # B1 at the prefill's rows: R's m nonzeros a row, then B's product, in f32
    ops1 = 4096 * 1024 + 2 * 4096 * 512 * 256
    by1 = 4 * 4096 * 1024 + 512 * 1024 + 4 * 256 * 512 + 4 * 4096 * 256
    assert flops.fused_transform_bound_s(4096, 1024, 512, 256) == pytest.approx(
        max(ops1 / 67e12, by1 / 3.35e12), rel=1e-12)
    # B2 rotation-only on 4096 rows, n 256, p 512: operations at the f32 peak
    ops2 = 2 * 4096 * 256 + 2 * 4096 * 256 * 256 + 2 * 256 * 256 * 512 + 2 * 256 * 512
    by2 = 4 * (4096 * 256 + 2 * 256 * 512)
    assert flops.easi_bound_s(4096, 256, 512, False) == pytest.approx(
        max(ops2 / 67e12, by2 / 3.35e12), rel=1e-12)
