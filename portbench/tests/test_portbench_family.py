"""The dense transformer, moved into `families/transformer.py`, is the family
it was: at both configurations' published sizes its leaves and every
count of operations the three first cells read are the numbers the
benchmark had before families were files, and the weights and DR state it
draws at the tiny sizes are bit for bit the ones it drew then."""

import hashlib

import pytest

pytest.importorskip("torch")

from portbench import arch, flops, weights
from portbench.tests import smoke

LEAVES = {
    "hubert-xlarge-dr": [
        ("embed", (512, 1280), 1.0), ("final_norm", (1280,), 0.0),
        ("frontend_proj", (128, 1280), 0.08838834764831843), ("layers/ln1", (48, 1280), 0.0),
        ("layers/ln2", (48, 1280), 0.0), ("layers/w_in", (48, 1280, 5120), 0.02795084971874737),
        ("layers/w_out", (48, 5120, 1280), 0.00142636082683637),
        ("layers/wk", (48, 1280, 1280), 0.02795084971874737),
        ("layers/wo", (48, 1280, 1280), 0.00285272165367274),
        ("layers/wq", (48, 1280, 1280), 0.02795084971874737),
        ("layers/wv", (48, 1280, 1280), 0.02795084971874737),
        ("lm_head", (1280, 512), 0.02795084971874737)],
    "internvl2-1b-dr": [
        ("embed", (151808, 896), 1.0), ("final_norm", (896,), 0.0),
        ("frontend_proj", (256, 896), 0.0625), ("layers/ln1", (24, 896), 0.0),
        ("layers/ln2", (24, 896), 0.0), ("layers/w_gate", (24, 896, 4864), 0.03340765523905305),
        ("layers/w_in", (24, 896, 4864), 0.03340765523905305),
        ("layers/w_out", (24, 4864, 896), 0.002069581807914131),
        ("layers/wk", (24, 896, 128), 0.03340765523905305),
        ("layers/wo", (24, 896, 896), 0.004821979686315372),
        ("layers/wq", (24, 896, 896), 0.03340765523905305),
        ("layers/wv", (24, 896, 128), 0.03340765523905305),
        ("lm_head", (896, 151808), 0.03340765523905305)],
}

# sha256 of every leaf's bytes in path order, and of R's then B's, at smoke.ARCH and smoke.SEED
DRAWS = {
    "hubert-xlarge-dr": ("7d0c3d23868d6617117bba07e973b794b81b6ca4e9b94556cc7538d6f1a0febd",
                         "752eb5b8fe6ce603ff0c17501f801c73243aba8962963360e95ebf47d335c112"),
    "internvl2-1b-dr": ("cb5455b8e077cf8ac9ca2d2cf45f42a031f1ea582d492ae129af51c3d3d81317",
                        "c7f461e350363f473ea7ee0c65aa85cd3f8db274d2f9dd12064b655b9913ac51"),
}


def _arch(name, overrides=None):
    return arch.sizes(arch.read(smoke.ROOT / "portbench" / "configs" / f"{name}.json")["arch"],
                      overrides)


@pytest.mark.parametrize("name", sorted(LEAVES))
def test_the_leaves_at_published_sizes(name):
    assert weights.leaf_specs(_arch(name)) == LEAVES[name]


def test_the_three_cells_counts_at_published_sizes():
    hu, iv = _arch("hubert-xlarge-dr"), _arch("internvl2-1b-dr")
    assert flops.train_flops(hu, 8, 1024) == 52610665021440.0
    assert flops.flash_bound_s(hu, 8, 1024, lse=True) == 4.3427374074823054e-05
    assert flops.prefill_flops(iv, 32, 512, 256) == 12099205988352.0
    assert flops.flash_bound_s(iv, 32, 512, lse=False) == 2.003249671641791e-05
    assert flops.prefill_flops(hu, 16, 1024, 1024) == 35052322816000.0
    assert flops.flash_bound_s(hu, 16, 1024, lse=False) == 8.685474814964611e-05


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_the_draws_at_tiny_sizes_are_bit_for_bit(name):
    import torch

    a = _arch(name, smoke.ARCH[name])
    p = weights.draw_params(a, smoke.SEED, smoke.CPU)
    assert list(p) == ["layers"] + [s[0] for s in LEAVES[name] if "/" not in s[0]]
    h = hashlib.sha256()
    for k in sorted(p):
        group = p[k] if isinstance(p[k], dict) else {"": p[k]}
        for kk in sorted(group):
            h.update(f"{k}/{kk}".encode())
            h.update(group[kk].contiguous().numpy().tobytes())
    r, b = weights.draw_dr(a, smoke.SEED, smoke.CPU)
    assert (h.hexdigest(), hashlib.sha256(r.numpy().tobytes() + b.numpy().tobytes()).hexdigest()) \
        == DRAWS[name]
    assert isinstance(p["layers"]["wq"], torch.Tensor)


def test_a_decode_counts_each_step_s_keys():
    iv = _arch("internvl2-1b-dr")
    per_layer = 2 * 896 * 896 + 2 * 896 * 128 + 3 * 896 * 4864
    dense = 2 * (24 * per_layer + 896 * 151808) * 16 * 64
    keys = sum(512 + t + 1 for t in range(64))
    attn = 4 * 16 * keys * 14 * 64 * 24
    assert flops.decode_flops(iv, 16, 512, 64) == pytest.approx(dense + attn, rel=1e-12)
