"""The port's DR ensembles (`DRModel.ensemble(k)`, `DREnsemble`) against
the reference's vmapped ensemble, their sharded serving (`dr_serve` with
`ensemble=k` on a one-rank gloo mesh) and `DRService.register(...,
ensemble=k)`.

Ensemble states are drawn by the reference (`DREnsemble.init` under
`jax.vmap`) and carried across member by member with `bridge`; data comes
from numpy with a seed.  The port runs its members one after another on
the CPU, the kernel backend taking the kernels' plain versions.
Tolerances: a transform at 1e-5 / 1e-6 (the reference's DR tests), an
update or a fit (a trajectory) at rtol 5e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.dr import DRModel as JModel
from repro.dr import EASIStage as JEASI
from repro.dr import RPStage as JRP
from repro_torch import bridge
from repro_torch.core.execution import Execution
from repro_torch.dr import DREnsemble, DRModel, EASIStage, RPStage
from repro_torch.dr.model import member, stack_members
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.serve import BucketPolicy, DRService, dr_serve

CPU_KERNEL = Execution(backend="kernel", device="cpu")
CPU = Execution(device="cpu")
K = 3


def _models(backend_exe=CPU_KERNEL, block_size=16):
    stages = lambda rp, easi: (rp(16, 8), easi.rotation(8, 4, mu=1e-3))
    return (JModel(stages=stages(JRP, JEASI), block_size=block_size),
            DRModel(stages=stages(RPStage, EASIStage), execution=backend_exe,
                    block_size=block_size))


def _import(jstate, k):
    """A reference ensemble state as the port's: member by member through
    `bridge`, restacked."""
    members = []
    for i in range(k):
        one = jax.tree.map(lambda a: np.asarray(a)[i], jstate)
        members.append(bridge.from_reference(one, device="cpu"))
    return stack_members(tuple(members))


def _x(n, m, seed):
    return np.random.default_rng(seed).standard_normal((n, m)).astype(np.float32)


@pytest.fixture(scope="module")
def ens():
    jm, tm = _models()
    jstate = jm.ensemble(K).init(jax.random.PRNGKey(11))
    return jm, tm, jstate, _import(jstate, K)


def test_init_lays_members_on_a_leading_axis(ens):
    jm, tm, jstate, tstate = ens
    own = tm.ensemble(K).init(torch.Generator().manual_seed(0))
    for got, ref in zip(own.stages, jstate.stages):
        assert tuple(got.shape) == tuple(ref.shape)
        assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    assert tuple(own.steps.shape) == (K,) and own.steps.dtype == torch.int32
    assert own.trainable == jstate.trainable
    # members differ: each draws after the one before it
    assert not torch.equal(own.stages[1][0], own.stages[1][1])
    for got, ref in zip(tstate.stages, jstate.stages):
        np.testing.assert_array_equal(bridge.to_array(got), np.asarray(ref))


def test_transform_matches_the_vmapped_reference(ens):
    jm, tm, jstate, tstate = ens
    x = _x(24, 16, 1)
    want = np.asarray(jm.ensemble(K).transform(jstate, jnp.asarray(x)))
    got = tm.ensemble(K).transform(tstate, torch.from_numpy(x))
    assert tuple(got.shape) == (K, 24, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_update_matches_the_vmapped_reference(ens):
    jm, tm, jstate, tstate = ens
    x = _x(16, 16, 2)
    want = jm.ensemble(K).update(jstate, jnp.asarray(x))
    got = tm.ensemble(K).update(tstate, torch.from_numpy(x))
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))
    np.testing.assert_allclose(got.stages[1].numpy(), np.asarray(want.stages[1]),
                               rtol=5e-4, atol=1e-6)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_fit_matches_the_vmapped_reference(ens, backend):
    jm, _, jstate, tstate = ens
    tm = _models(Execution(backend=backend, device="cpu"))[1]
    x = _x(256, 16, 3)
    want = jm.ensemble(K).fit(jstate, jnp.asarray(x), epochs=2)
    got = tm.ensemble(K).fit(tstate, torch.from_numpy(x), epochs=2)
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))
    np.testing.assert_allclose(got.stages[1].numpy(), np.asarray(want.stages[1]),
                               rtol=5e-4, atol=1e-6)
    # the members stay apart (different inits)
    assert float(torch.abs(got.stages[1][0] - got.stages[1][2]).max()) > 1e-4


def test_members_equal_their_solo_runs_bit_for_bit(ens):
    """Member i of fit + transform is member i run alone as a `DRModel`."""
    _, tm, _, tstate = ens
    x = torch.from_numpy(_x(128, 16, 4))
    fitted = tm.ensemble(K).fit(tstate, x, epochs=2)
    ye = tm.ensemble(K).transform(fitted, x[:8])
    for i in range(K):
        solo_state = member(tstate, i)
        solo_state = solo_state._replace(stages=tuple(s.clone() for s in solo_state.stages))
        solo = tm.fit(solo_state, x, epochs=2)
        assert torch.equal(fitted.stages[1][i], solo.stages[1])
        assert int(fitted.steps[i]) == int(solo.steps)
        assert torch.equal(ye[i], tm.transform(solo, x[:8]))


def test_a_state_without_the_member_axis_is_refused(ens):
    _, tm, _, tstate = ens
    with pytest.raises(ValueError, match=r"leading \(2,\) axis"):
        tm.ensemble(2).transform(tstate, torch.zeros((4, 16)))
    with pytest.raises(ValueError, match="ensemble size"):
        DREnsemble(model=tm, k=0)


def test_ensemble_serving_on_a_one_rank_mesh():
    """The twin of tests/test_dr_model.py::TestServeEndpoint::
    test_ensemble_serving: a whitening ensemble of 2 through
    `make_dr_transform(..., ensemble=2)` on `make_smoke_mesh(1)`, here a
    one-rank gloo group; the answer equals the ensemble's own transform."""
    jm = JModel(stages=(JEASI.whiten(16, 4),))
    tm = DRModel(stages=(EASIStage.whiten(16, 4),), execution=CPU_KERNEL)
    jstate = jm.ensemble(2).init(jax.random.PRNGKey(15))
    tstate = _import(jstate, 2)
    x = torch.from_numpy(_x(8, 16, 16))
    mesh = make_smoke_mesh(1, device="cpu")
    assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    step = dr_serve.make_dr_transform(tm, mesh, batch_size=8, ensemble=2)
    y = step(tstate, x)
    assert tuple(y.shape) == (2, 8, 4)
    np.testing.assert_allclose(y.full_tensor().numpy(),
                               np.asarray(jm.ensemble(2).transform(jstate, jnp.asarray(x.numpy()))),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(y.to_local(), tm.ensemble(2).transform(tstate, x))


@pytest.mark.parametrize("mesh", [False, True], ids=["no-mesh", "one-rank-mesh"])
def test_service_serves_a_registered_ensemble(ens, mesh):
    """`register(..., ensemble=3)`: one-shot and micro-batched answers are
    (3, rows, 4), each the ensemble's transform of the request's rows; a
    state without the member axis is refused at register, and
    train-while-serve refuses an ensemble as the reference does."""
    _, tm, _, tstate = ens
    svc = DRService(mesh=make_smoke_mesh(1, device="cpu") if mesh else None,
                    buckets=BucketPolicy(min_bucket=8, max_bucket=32))
    svc.register("e", tm, tstate, ensemble=K)
    xs = [torch.from_numpy(_x(n, 16, 20 + n)) for n in (3, 11, 40)]
    for x in xs:
        got = svc.transform("e", x)
        assert tuple(got.shape) == (K, x.shape[0], 4)
        np.testing.assert_allclose(got.numpy(), tm.ensemble(K).transform(tstate, x).numpy(),
                                   rtol=1e-6, atol=1e-7)
    tickets = [svc.submit("e", x) for x in xs[:2]]
    svc.flush()
    for t, x in zip(tickets, xs[:2]):
        np.testing.assert_allclose(t.result().numpy(),
                                   tm.ensemble(K).transform(tstate, x).numpy(),
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="leading"):
        svc.register("bad", tm, member(tstate, 0), ensemble=K)
    with pytest.raises(NotImplementedError, match="single models"):
        svc.serve_and_update("e", xs[0])
