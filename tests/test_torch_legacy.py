"""The port's legacy facade (`core/dr_unit.py`, `dr/legacy.py`) and
`execution.resolve` against the JAX package on the CPU, for each of the six
`DRConfig` kinds: the stage composition, trajectories on an imported state,
the Table II cost model and the refusals."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import dr_unit as j_unit
from repro_torch import bridge
from repro_torch import dr as tdr
from repro_torch.core import dr_unit as t_unit
from repro_torch.core import easi as t_easi
from repro_torch.core import pipeline as t_pipeline
from repro_torch.core import random_projection as t_rp
from repro_torch.core.execution import KERNEL, TORCH, Execution, resolve
from repro_torch.dr import legacy as t_legacy

CPU = Execution(device="cpu")
TRAJ = dict(rtol=5e-4, atol=5e-5)
KINDS = list(t_unit.KINDS)


def _kw(kind, **kw):
    kw.setdefault("block_size", 4)
    if kind.startswith("rp_"):
        kw.setdefault("p", 12)
    return dict(kind=kind, m=16, n=8, mu=1e-3, **kw)


def _cfgs(kind, **kw):
    return j_unit.DRConfig(**_kw(kind, **kw)), t_unit.DRConfig(**_kw(kind, **kw))


def _import(j_state):
    """A reference DRState as a port DRState on the CPU."""
    return bridge.dr_state_from_reference(j_state, device="cpu")


def _stage_fields(stage):
    return type(stage).__name__, {k: v for k, v in dataclasses.asdict(stage).items()
                                  if k != "dtype"}


def _x(n, m=16, seed=8):
    return np.random.default_rng(seed).standard_normal((n, m)).astype(np.float32)


def _assert_state(t_state, j_state, tol):
    for got, want in ((t_state.r, j_state.r), (t_state.b, j_state.b)):
        if want is None:
            assert got is None
        else:
            np.testing.assert_allclose(bridge.to_array(got), np.asarray(want), **tol)
    assert int(t_state.steps) == int(j_state.steps)


@pytest.mark.parametrize("kind", KINDS)
def test_from_legacy_structure_matches_reference(kind):
    jc, tc = _cfgs(kind)
    jm, tm = j_unit.from_legacy(jc), t_unit.from_legacy(tc)
    assert [_stage_fields(s) for s in tm.stages] == [_stage_fields(s) for s in jm.stages]
    assert tm.block_size == jm.block_size and tm.dims == jm.dims
    assert tm.trainable_mask == jm.trainable_mask
    assert isinstance(t_legacy.model_from_config(tc), tdr.DRModel)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("kind", KINDS)
def test_fit_trajectory_on_an_imported_state(kind, backend):
    jc, tc = _cfgs(kind)
    x = _x(256)
    j0 = j_unit.init(jax.random.PRNGKey(7), jc)
    j_fit = j_unit.fit(j0, jc, jnp.asarray(x), epochs=2)
    exe = Execution(backend=backend, device="cpu")
    t_fit = t_unit.fit(_import(j0), tc, x, epochs=2, execution=exe)
    _assert_state(t_fit, j_fit, TRAJ)
    if j_fit.r is not None:
        assert torch.equal(t_fit.r, bridge.to_tensor(np.asarray(j_fit.r), "cpu"))
    probe = _x(13, seed=9)
    np.testing.assert_allclose(
        t_unit.transform(t_fit, tc, probe, execution=exe).numpy(),
        np.asarray(j_unit.transform(j_fit, jc, jnp.asarray(probe))), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", [k for k in KINDS if k != "rp"])
def test_single_update_on_an_imported_state(kind):
    jc, tc = _cfgs(kind)
    j0 = j_unit.init(jax.random.PRNGKey(0), jc)
    x = _x(4, seed=1)
    j_up = j_unit.update(j0, jc, jnp.asarray(x))
    t_up = t_unit.update(_import(j0), tc, x, execution=CPU)
    _assert_state(t_up, j_up, dict(rtol=1e-5, atol=1e-6))
    assert int(t_up.steps) == 1


def test_use_kernel_flag_runs_the_kernel_backend():
    jc, tc = _cfgs("rp_easi")
    j0 = j_unit.init(jax.random.PRNGKey(3), jc)
    x = _x(64)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: use_kernel alone would run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_unit.fit(_import(j0), tc, x, use_kernel=True)
    assert t_unit.from_legacy(tc, use_kernel=True).execution == KERNEL
    assert t_unit.from_legacy(tc).execution == TORCH


@pytest.mark.parametrize("kind", KINDS + ["rp_easi_no_bypass"])
def test_mac_counts_and_stage_configs_match_reference(kind):
    kw = dict(bypass_whitening=False) if kind == "rp_easi_no_bypass" else {}
    jc, tc = _cfgs(kind.replace("_no_bypass", ""), **kw)
    assert tc.mac_counts() == jc.mac_counts()
    assert t_unit.from_legacy(tc).mac_counts()["per_stage"] == \
        j_unit.from_legacy(jc).mac_counts()["per_stage"]
    for t_cfg, j_cfg in ((tc.rp_cfg, jc.rp_cfg), (tc.easi_cfg, jc.easi_cfg)):
        if j_cfg is None:
            assert t_cfg is None
            continue
        t_fields = {k: v for k, v in dataclasses.asdict(t_cfg).items() if k != "dtype"}
        j_fields = {k: v for k, v in dataclasses.asdict(j_cfg).items() if k != "dtype"}
        assert t_fields == j_fields


@pytest.mark.parametrize("kw", [
    dict(kind="pca", m=16, n=8),
    dict(kind="rp_easi", m=16, n=8),
    dict(kind="rp_whiten", m=16, p=6, n=8),
    dict(kind="rp_easi", m=16, p=20, n=8),
])
def test_config_refusals_match_reference(kw):
    with pytest.raises(ValueError) as j_err:
        j_unit.DRConfig(**kw)
    with pytest.raises(ValueError) as t_err:
        t_unit.DRConfig(**kw)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("kind", KINDS)
def test_init_places_the_state_and_matches_the_reference_shapes(kind):
    jc, tc = _cfgs(kind)
    j0 = j_unit.init(jax.random.PRNGKey(1), jc)
    t0 = t_unit.init(torch.Generator().manual_seed(1), tc, execution=CPU)
    for got, want in ((t0.r, j0.r), (t0.b, j0.b)):
        if want is None:
            assert got is None
            continue
        assert tuple(got.shape) == want.shape and got.device.type == "cpu"
        assert bridge.to_array(got).dtype == np.asarray(want).dtype
    assert int(t0.steps) == 0
    r = t_unit.sample_r(torch.Generator().manual_seed(1), tc)
    if jc.rp_cfg is None:
        assert r is None
    else:
        assert r.dtype == torch.int8 and set(r.unique().tolist()) <= {-1, 0, 1}
        assert torch.equal(r, t_rp.sample_ternary(torch.Generator().manual_seed(1), tc.rp_cfg))


def test_init_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_unit.init(torch.Generator().manual_seed(0), _cfgs("rp_easi")[1])


def test_rp_easi_no_bypass_keeps_second_order():
    _, tc = _cfgs("rp_easi", bypass_whitening=False)
    stage = t_unit.from_legacy(tc).stages[-1]
    assert stage.second_order and stage.higher_order


def test_easi_only_nondefault_dtype_casts_like_legacy():
    """An EASI-only kind casts x to cfg.dtype: a bf16 stage stays bf16."""
    _, tc = _cfgs("easi", dtype=torch.bfloat16)
    st = t_unit.init(torch.Generator().manual_seed(20), tc, execution=CPU)
    x = torch.from_numpy(_x(16, seed=21))
    y = t_unit.transform(st, tc, x, execution=CPU)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, t_easi.transform(st.b, x.to(torch.bfloat16)))


def test_predict_accepts_pre_refactor_state_dict():
    _, tc = _cfgs("rp_easi", block_size=16)
    st = t_unit.init(torch.Generator().manual_seed(22), tc, execution=CPU)
    x = _x(64, seed=23)
    y = np.random.default_rng(24).integers(0, 3, size=64)
    tcfg = t_pipeline.TwoStageConfig(dr=tc, dr_epochs=1, head_epochs=2, head_batch=32)
    fitted = t_pipeline.fit_two_stage(tcfg, x, y, execution=CPU)
    old_style = {**fitted, "dr_state": st}
    old_style.pop("dr_model")
    logits = t_pipeline.predict(old_style, x, execution=CPU)
    assert tuple(logits.shape) == (64, 3)
    model = t_unit.from_legacy(tc, execution=CPU)
    want = t_pipeline.predict({**fitted, "dr_model": model,
                               "dr_state": t_legacy.legacy_to_model_state(model, st)}, x)
    assert torch.equal(logits, want)


def test_legacy_state_round_trip():
    _, tc = _cfgs("rp_whiten")
    st = t_unit.init(torch.Generator().manual_seed(4), tc, execution=CPU)
    model = t_unit.from_legacy(tc, execution=CPU)
    mstate = t_legacy.legacy_to_model_state(model, st)
    assert mstate.trainable == (False, True)
    assert mstate.r is st.r and mstate.b is st.b
    r, b, steps = t_legacy.model_to_legacy_fields(mstate)
    assert r is st.r and b is st.b and steps is st.steps


def test_resolve_maps_the_flag_onto_the_default_policies():
    assert resolve(None, True).backend == "kernel"
    assert resolve(None, False).backend == "torch"
    assert resolve(None, True).device == resolve(None, False).device == "cuda"
    assert resolve(CPU, True) is CPU
    assert resolve(Execution(backend="torch"), True).backend == "torch"


def test_two_stage_accepts_model_and_config():
    """tests/test_dr_model.py::TestPipelineDRModel, on the port: the same
    stages from a DRModel or a DRConfig, the same seed, the same accuracy."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((512, 16)).astype(np.float32)
    y = rng.integers(0, 3, size=512)
    model = tdr.DRModel(stages=(tdr.RPStage(16, 8), tdr.EASIStage.rotation(8, 4, mu=5e-4)),
                        block_size=16)
    legacy = t_unit.DRConfig(kind="rp_easi", m=16, p=8, n=4, mu=5e-4, block_size=16)
    accs = {}
    for tag, dr in (("model", model), ("config", legacy)):
        cfg = t_pipeline.TwoStageConfig(dr=dr, dr_epochs=1, head_epochs=3, seed=0)
        fitted = t_pipeline.fit_two_stage(cfg, x, y, execution=CPU)
        assert isinstance(fitted["dr_state"], tdr.ModelState)
        assert tuple(fitted["dr_state"].b.shape) == (4, 8)
        accs[tag] = t_pipeline.evaluate(fitted, x, y)
    assert accs["model"] == accs["config"]

