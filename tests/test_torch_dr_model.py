"""The port's DRModel (`transform` / `update` / `fit`) against the JAX
package's `repro.dr.DRModel` on the CPU, on states drawn by the reference
and imported through numpy (`repro_torch.bridge`)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.dr as jdr
from repro.data import waveform as j_waveform
from repro_torch import bridge
from repro_torch import dr as tdr
from repro_torch.data import waveform as t_waveform

TRAJ = dict(rtol=5e-4, atol=5e-5)      # the reference's kernel-vs-XLA trajectory bound
OUT = dict(rtol=1e-4, atol=1e-4)


def _stages(pkg, name):
    """The configurations of configs/waveform_paper.py, in either package."""
    rp, ea = pkg.RPStage, pkg.EASIStage
    return {
        "easi_n16": ((ea.full(32, 16, mu=1e-3),), 1),
        "rp24_easi_n16": ((rp(32, 24), ea.rotation(24, 16, mu=2e-4)), 32),
        "whiten_n16": ((ea.whiten(32, 16, mu=1e-3),), 1),
        "rp24_whiten16_rot8": ((rp(32, 24), ea.whiten(24, 16, mu=5e-4),
                                ea.rotation(16, 8, mu=2e-4)), 32),
    }[name]


def _models(name, backend):
    j_stages, block = _stages(jdr, name)
    t_stages, _ = _stages(tdr, name)
    jm = jdr.DRModel(stages=j_stages, block_size=block)
    tm = tdr.DRModel(stages=t_stages, block_size=block,
                     execution=tdr.Execution(backend=backend, device="cpu"))
    return jm, tm


def _data(n=400):
    (x, _), _ = t_waveform.paper_split(seed=0)
    x = x[:n]
    x = (x - x.mean(0)) / (np.sqrt(np.mean(np.var(x - x.mean(0), axis=0))) + 1e-8)
    return x.astype(np.float32)


def _assert_states(t_state, j_state, tol):
    stages, steps, trainable = bridge.to_numpy(t_state)
    assert int(steps) == int(j_state.steps)
    assert trainable == j_state.trainable
    for got, want in zip(stages, j_state.stages):
        np.testing.assert_allclose(got, np.asarray(want), **tol)


CONFIGS = ["easi_n16", "rp24_easi_n16", "whiten_n16", "rp24_whiten16_rot8"]


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("name", CONFIGS)
def test_fit_transform_update_match_reference(name, backend):
    jm, tm = _models(name, backend)
    j0 = jm.init(jax.random.PRNGKey(0))
    t0 = bridge.from_reference(j0, device="cpu")
    x = _data()

    jf = jm.fit(j0, jnp.asarray(x), epochs=2)
    tf = tm.fit(t0, x, epochs=2)
    _assert_states(tf, jf, TRAJ)

    probe = x[:37]
    np.testing.assert_allclose(tm.transform(tf, probe).numpy(),
                               np.asarray(jm.transform(jf, jnp.asarray(probe))), **OUT)

    ju = jm.update(jf, jnp.asarray(probe))
    tu = tm.update(tf, probe)
    _assert_states(tu, ju, TRAJ)


def test_update_feeds_each_stage_from_pre_update_states():
    _, tm = _models("rp24_whiten16_rot8", "torch")
    st = tm.init(torch.Generator().manual_seed(1))
    x = torch.from_numpy(_data(32))
    up = tm.update(st, x)
    h = x
    for i, (stage, s) in enumerate(zip(tm.stages, st.stages)):
        assert torch.equal(up.stages[i], stage.update(s, h, tm.execution))
        h = stage.transform(s, h, tm.execution)


def test_cascade_fit_matches_manual_updates():
    _, tm = _models("rp24_whiten16_rot8", "kernel")
    st = tm.init(torch.Generator().manual_seed(2))
    x = torch.from_numpy(_data(100))           # 3 blocks of 32, 4 rows dropped
    fitted = tm.fit(st, x)
    manual = st
    for i in range(3):
        manual = tm.update(manual, x[i * 32:(i + 1) * 32])
    for a, b in zip(fitted.stages, manual.stages):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert int(fitted.steps) == int(manual.steps) == 3


@pytest.mark.parametrize("name,epochs,rows,want", [
    ("easi_n16", 2, 50, 100), ("rp24_easi_n16", 3, 100, 9), ("rp24_whiten16_rot8", 1, 64, 2)])
def test_steps_arithmetic(name, epochs, rows, want):
    _, tm = _models(name, "torch")
    st = tm.init(torch.Generator().manual_seed(0))
    st = tm.fit(st, _data(rows), epochs=epochs)
    assert st.steps.dtype == torch.int32 and int(st.steps) == want


def test_static_only_chain_counts_steps():
    tm = tdr.DRModel(stages=(tdr.RPStage(32, 16),), block_size=8,
                     execution=tdr.Execution(device="cpu"))
    st = tm.init(torch.Generator().manual_seed(0))
    fitted = tm.fit(st, _data(20), epochs=2)
    assert int(fitted.steps) == 4 and fitted.stages[0] is st.stages[0]


def test_state_accessors_and_sniff_fallback():
    _, tm = _models("rp24_whiten16_rot8", "torch")
    st = tm.init(torch.Generator().manual_seed(0))
    assert st.r is st.stages[0] and st.r.dtype == torch.int8
    assert st.b is st.stages[2]
    bare = tdr.ModelState(stages=st.stages, steps=st.steps)
    assert bare.r is st.stages[0] and bare.b is st.stages[2]
    easi_only = tdr.ModelState(stages=(st.stages[1],), steps=st.steps, trainable=(True,))
    assert easi_only.r is None and easi_only.b is st.stages[1]
    with pytest.raises(ValueError, match="unexpected"):
        st._replace(bogus=1)


def test_dim_mismatch_and_block_size_raise():
    with pytest.raises(ValueError, match="chain"):
        tdr.DRModel(stages=(tdr.RPStage(32, 16), tdr.EASIStage.full(12, 8)))
    with pytest.raises(ValueError, match="block_size"):
        tdr.DRModel(stages=(tdr.RPStage(32, 16),), block_size=0)
    with pytest.raises(ValueError, match="at least one"):
        tdr.DRModel(stages=())


def test_mac_counts_match_reference():
    jm, tm = _models("rp24_whiten16_rot8", "torch")
    assert tm.mac_counts() == jm.mac_counts()
    assert tm.dims == jm.dims == (32, 24, 16, 8)


def test_bf16_state_crosses_bit_for_bit():
    j_stages, block = _stages(jdr, "rp24_easi_n16")
    jm = jdr.DRModel(stages=j_stages, block_size=block,
                     execution=jdr.Execution(dtype=jnp.bfloat16))
    js = jm.init(jax.random.PRNGKey(3))
    ts = bridge.from_reference(js, device="cpu")
    assert ts.b.dtype == torch.bfloat16
    np.testing.assert_array_equal(bridge.to_array(ts.b), np.asarray(js.b, np.float32))


def test_waveform_copy_gives_reference_arrays():
    for seed in (0, 3):
        (tx, ty), (vx, vy) = t_waveform.paper_split(seed=seed)
        (jx, jy), (wx, wy) = j_waveform.paper_split(seed=seed)
        for a, b in ((tx, jx), (ty, jy), (vx, wx), (vy, wy)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_waveform.generate(50, seed=1)[0],
                                  j_waveform.generate(50, seed=1)[0])
