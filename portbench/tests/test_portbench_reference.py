"""The benchmark's plain reference against the port's CPU path at tiny sizes,
both in float32: the forward's last logits, two training steps with the
DR unit co-trained, and the DR front end alone."""

import pytest

pytest.importorskip("torch")

import torch

from portbench import arch, generate, weights
from portbench.reference import transformer as ref
from portbench.tests import smoke


def _arch(name, **kw):
    cfg = arch.read(smoke.ROOT / "portbench" / "configs" / f"{name}.json")["arch"]
    return arch.sizes(cfg, dict(smoke.ARCH[name], **kw))


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("name", ["hubert-xlarge-dr", "internvl2-1b-dr"])
def test_last_logits_match_the_port(name):
    from repro_torch.core.execution import Execution
    from repro_torch.models import api

    a = _arch(name)
    cfg = arch.port_config(a)
    params = weights.draw_params(a, smoke.SEED, smoke.CPU)
    g = torch.Generator().manual_seed(3)
    n = 3
    p_rows = a.frontend_seq if a.frontend == "vision" else 24
    feats = torch.randn((n, p_rows, a.dr_frontend.n), generator=g)
    tokens = torch.randint(0, a.vocab_size, (n, 10), generator=g, dtype=torch.int32)
    batch = {"patches": feats, "tokens": tokens} if a.frontend == "vision" else {"frames": feats}
    s = p_rows + (10 if a.frontend == "vision" else 0)
    got, _ = api.prefill(params, batch, cfg, s, execution=Execution(device="cpu"))
    ref.strict_f32()
    want = ref.last_logits(params, a, feats, tokens if a.frontend == "vision" else None, "f32")
    assert _rel(got, want) < 1e-5


def test_dr_front_end_matches_the_port():
    from repro_torch.core import dr_unit
    from repro_torch.core.execution import Execution

    a = _arch("internvl2-1b-dr")
    spec = a.dr_frontend
    r, b = weights.draw_dr(a, smoke.SEED, smoke.CPU)
    x = torch.randn((64, a.frontend_dim), generator=torch.Generator().manual_seed(4))
    dcfg = dr_unit.DRConfig(kind=spec.kind, m=a.frontend_dim, p=spec.p, n=spec.n, mu=spec.mu,
                            bypass_whitening=spec.bypass_whitening)
    st = dr_unit.DRState(r=r, b=b, steps=torch.zeros((), dtype=torch.int32))
    exe = Execution(backend="kernel", device="cpu")
    got = dr_unit.transform(st, dcfg, x, execution=exe)
    assert _rel(got, ref.dr_transform(r, b, x, "f32")) < 1e-6
    nb = dr_unit.update(st, dcfg, x, execution=exe).b
    want = ref.easi_update(r, b, x, spec.mu, False, "f32")
    assert _rel(nb - b, want - b) < 1e-4


def test_training_steps_match_the_port():
    from repro_torch.core import dr_unit
    from repro_torch.core.execution import Execution
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts

    a = _arch("hubert-xlarge-dr")
    cfg = arch.port_config(a)
    tr = dict(batch=2, seq=32)
    mix = generate.mixing(smoke.SEED, a.frontend_dim, smoke.CPU)
    batches = [generate.train_batch(smoke.SEED, k, tr, a, mix, smoke.CPU) for k in range(2)]
    params = weights.draw_params(a, smoke.SEED, smoke.CPU)
    r, b = weights.draw_dr(a, smoke.SEED, smoke.CPU)
    zero = torch.zeros((), dtype=torch.int32)
    state = ts.TrainState(params=params, opt=opt_mod.init(params),
                          dr=dr_unit.DRState(r=r, b=b.clone(), steps=zero.clone()), step=zero)
    step = ts.make_train_step(ts.TrainConfig(arch=cfg), execution=Execution(device="cpu"))
    losses = []
    for bt in batches:
        state, met = step(state, bt)
        losses.append(float(met["loss"]))

    ref.strict_f32()
    rp = weights.draw_params(a, smoke.SEED, smoke.CPU)
    for t in ref.leaves(rp).values():
        t.requires_grad_(True)
    opt = {"t": 0, "m": {}, "v": {}}
    rb = b.clone()
    for k, bt in enumerate(batches):
        loss, _, rb = ref.train_step(rp, opt, (r, rb), bt, a, ref.Precision())
        assert float(loss) == pytest.approx(losses[k], rel=1e-5)
    want = ref.leaves(rp)
    for path, t in ref.leaves(state.params).items():
        p0 = weights.draw_leaf(smoke.SEED, next(s for s in weights.leaf_specs(a)
                                               if s[0] == path), smoke.CPU)
        moved = want[path].detach() - p0
        if float(moved.norm()) > 0:
            assert _rel(t - p0, moved) < 2e-3, path
    assert _rel(state.dr.b - b, rb - b) < 1e-3


def test_a_decode_matches_the_reference_s_full_forward():
    """The answer cell at tiny sizes: the program's prefill and every decode
    step's logits against one forward pass of the reference over the prompt
    and the tokens the decode fed, both in float32."""
    res, checks = smoke.run("internvl2-1b-dr.answer")
    assert res["correct"] and res["attempted"] > 0
    assert checks["logits"]["value"] < 1e-5 and checks["decode_logits"]["value"] < 1e-5


def test_stream_logits_end_where_the_last_logits_are():
    a = _arch("internvl2-1b-dr")
    params = weights.draw_params(a, smoke.SEED, smoke.CPU)
    g = torch.Generator().manual_seed(5)
    feats = torch.randn((2, a.frontend_seq, a.dr_frontend.n), generator=g)
    tokens = torch.randint(0, a.vocab_size, (2, 6), generator=g, dtype=torch.int32)
    ref.strict_f32()
    s = a.frontend_seq + 6
    lg = ref.stream_logits(params, a, feats, tokens, s - 3, "f32")
    assert lg.shape == (2, 3, a.padded_vocab)
    assert _rel(lg[:, -1], ref.last_logits(params, a, feats, tokens, "f32")) < 1e-6
