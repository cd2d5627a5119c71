"""The traffic generator: the same seed gives the same inputs, another seed
other inputs, at seeds past 32 bits."""

import pytest

pytest.importorskip("torch")

import torch

from portbench import arch, generate, weights
from portbench.tests import smoke


def _arch(name):
    cfg = arch.read(smoke.ROOT / "portbench" / "configs" / f"{name}.json")["arch"]
    return arch.sizes(cfg, smoke.ARCH[name])


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 33 + 12345])
def test_training_batches_repeat(seed):
    a = _arch("hubert-xlarge-dr")
    tr = dict(batch=2, seq=16)
    mix = generate.mixing(seed, a.frontend_dim, smoke.CPU)
    one = generate.train_batch(seed, 3, tr, a, mix, smoke.CPU)
    two = generate.train_batch(seed, 3, tr, a, generate.mixing(seed, a.frontend_dim, smoke.CPU),
                               smoke.CPU)
    assert set(one) == {"tokens", "frames"}
    for k in one:
        assert torch.equal(one[k], two[k])
    other = generate.train_batch(seed, 4, tr, a, mix, smoke.CPU)
    assert not torch.equal(one["frames"], other["frames"])
    assert int(one["tokens"].max()) < a.vocab_size and int(one["tokens"].min()) >= 0


def test_seeds_differ_and_requests_repeat():
    a = _arch("internvl2-1b-dr")
    tr = dict(sequences=3, prefix_rows=5, text_tokens=7)
    mix = generate.mixing(11, a.frontend_dim, smoke.CPU)
    r1 = generate.request(11, 2, tr, a, mix, smoke.CPU)
    r2 = generate.request(11, 2, tr, a, mix, smoke.CPU)
    assert r1["rows"].shape == (15, a.frontend_dim) and r1["tokens"].shape == (3, 7)
    assert torch.equal(r1["rows"], r2["rows"]) and torch.equal(r1["tokens"], r2["tokens"])
    r3 = generate.request(12, 2, tr, a, generate.mixing(12, a.frontend_dim, smoke.CPU),
                          smoke.CPU)
    assert not torch.equal(r1["rows"], r3["rows"])
    # unit variance a feature, as the DR stage takes its rows
    big = generate.request(11, 0, dict(sequences=64, prefix_rows=64, text_tokens=0), a, mix,
                           smoke.CPU)["rows"]
    assert 0.7 < float(big.var(dim=0).mean()) < 1.3


def test_weights_repeat_leaf_by_leaf():
    a = _arch("hubert-xlarge-dr")
    p = weights.draw_params(a, smoke.SEED, smoke.CPU)
    for spec in weights.leaf_specs(a):
        again = weights.draw_leaf(smoke.SEED, spec, smoke.CPU)
        group, _, name = spec[0].rpartition("/")
        assert torch.equal((p[group] if group else p)[name], again), spec[0]
    r, b = weights.draw_dr(a, smoke.SEED, smoke.CPU)
    assert r.dtype == torch.int8 and set(r.unique().tolist()) <= {-1, 0, 1}
    assert bool((r != 0).any(dim=1).all())
    assert torch.allclose(b @ b.T, torch.eye(b.shape[0]), atol=1e-5)
