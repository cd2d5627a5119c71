"""B2's column tile: `Execution.easi_block_m` reaches the port's `easi_apply`
as the reference's `block_m` reaches its Pallas kernel.

On the card the value picks how many columns of B one CTA updates, among
the templates `csrc/easi_update.cu` compiles (`resource_model.
effective_easi_tile`); every template gives the same bits, which
`chip_smoke.py --only kernels` holds there.  Here, on the CPU: the
reference's column-tiling test run against the port at each of its tiles,
the mapping onto the templates, the policy's value reaching the kernel
wrapper from `DRModel.update` / `fit`, and the serving registry telling two
policies apart by it."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.easi_update import easi_apply as pallas_easi_apply
from repro_torch.dr import DRModel, EASIStage, Execution, RPStage
from repro_torch.kernels import easi_update
from repro_torch.kernels import resource_model as rm
from repro_torch.serve.registry import ModelRegistry

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
PAPER_ROW, TILING, WIDE_ROW = (32, 16, 24), (64, 32, 1000), (256, 128, 256)


@pytest.fixture(scope="module")
def tiling_inputs():
    """tests/test_kernels.py's test_column_tiling_invariance inputs."""
    b_mat = jax.random.normal(jax.random.PRNGKey(2), (32, 1000), jnp.float32) * 0.2
    y = jax.random.normal(jax.random.PRNGKey(3), (64, 32), jnp.float32)
    return b_mat, y


@pytest.mark.parametrize("bm", [128, 256, 512])
def test_column_tiling_matches_the_reference_at_its_tile(bm, tiling_inputs):
    """The twin of the reference's test_column_tiling_invariance: its Pallas
    kernel at block_m = bm in interpret mode against the port's wrapper at
    the same block_m, on the CPU."""
    b_mat, y = tiling_inputs
    want = np.asarray(pallas_easi_apply(b_mat, y, mu=1e-3, block_m=bm, interpret=True))
    got = easi_update.easi_apply(torch.from_numpy(np.array(b_mat)),
                                 torch.from_numpy(np.array(y)), mu=1e-3, block_m=bm)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("shape,block_m,cols", [
    # the paper row takes the small body; m = 24 fits the narrowest template
    (PAPER_ROW, 32, 32), (PAPER_ROW, 64, 32), (PAPER_ROW, 128, 32), (PAPER_ROW, 512, 32),
    # the reference's tiling shape: small body, its templates as named, the
    # Pallas sizes 256 / 512 (512: the policy's default) and a split-body
    # width run the narrowest
    (TILING, 64, 64), (TILING, 128, 128), (TILING, 256, 32), (TILING, 512, 32),
    (TILING, 16, 32), (TILING, 1, 32),
    # the wide row takes the split body: 16 / 32 / 64, anything else 16
    (WIDE_ROW, 16, 16), (WIDE_ROW, 32, 32), (WIDE_ROW, 64, 64), (WIDE_ROW, 128, 16),
    (WIDE_ROW, 512, 16),
    # the clamp to m in either body
    ((256, 128, 20), 64, 32), ((256, 128, 33), 64, 64), ((64, 32, 40), 128, 64),
])
def test_effective_easi_tile_maps_block_m_onto_the_templates(shape, block_m, cols):
    assert rm.effective_easi_tile(*shape, block_m) == cols
    assert rm.effective_easi_tile(*shape, cols) == cols                 # idempotent
    body = rm.easi_apply_call(*shape, block_m=block_m)[-1]
    assert body.grid[-1] == -(-shape[2] // cols)                        # the CTAs along m


def test_the_sources_compile_the_model_s_column_templates():
    """easi_update.cuh's narrowest widths (a body's templates are lo, 2 lo,
    4 lo), one easi_small_<CT>.cu a small-body width, each in the build."""
    from repro_torch.kernels import _build

    text = (CSRC / "easi_update.cuh").read_text()
    ct = int(re.search(r"constexpr int ES_CT = (\d+);", text).group(1))
    ut = int(re.search(r"constexpr int ES_UT = (\d+);", text).group(1))
    assert (ct, 2 * ct, 4 * ct) == rm.EASI_SMALL_COLS
    assert (ut, 2 * ut, 4 * ut) == rm.EASI_SPLIT_COLS
    widths = {int(re.fullmatch(r"easi_small_(\d+)\.cu", p.name).group(1))
              for p in CSRC.glob("easi_small_*.cu")}
    assert widths == set(rm.EASI_SMALL_COLS)
    for ct in widths:
        assert f"REPRO_EASI_SMALL_WIDTH({ct})" in (CSRC / f"easi_small_{ct}.cu").read_text()
        assert f"easi_small_{ct}.cu" in _build.SOURCES
    for est in rm.every_instance():
        if est.kernel in ("easi_small_kernel", "easi_update_kernel"):
            assert est.validate() == [], est


@pytest.fixture
def spy(monkeypatch):
    """Every block_m `kernels.easi_update.easi_apply` is handed."""
    seen = []
    real = easi_update.easi_apply

    def record(*args, block_m=512, **kw):
        seen.append(block_m)
        return real(*args, block_m=block_m, **kw)

    monkeypatch.setattr(easi_update, "easi_apply", record)
    return seen


def _paper_model(**policy):
    return DRModel(stages=(RPStage(32, 24), EASIStage.rotation(24, 16)),
                   execution=Execution(backend="kernel", device="cpu", **policy), block_size=8)


@pytest.mark.parametrize("entry", ["update", "fit"])
def test_the_policy_s_tile_reaches_the_kernel_wrapper(entry, spy):
    """`DRModel.update` (dr/stages.py) and `fit` (core/easi.py's easi_fit)
    hand `Execution.easi_block_m` to the kernel wrapper, and the answer
    does not depend on it."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((32, 32)).astype(np.float32))
    outs = []
    for block_m in (64, 512):
        model = _paper_model(easi_block_m=block_m)
        state = model.init(torch.Generator().manual_seed(0))
        spy.clear()
        state = model.update(state, x[:8]) if entry == "update" else model.fit(state, x)
        assert spy and set(spy) == {block_m}
        outs.append(state.stages[1])
    assert torch.equal(outs[0], outs[1])


def test_two_policies_that_differ_in_the_tile_register_apart():
    reg = ModelRegistry()
    a, b = _paper_model(easi_block_m=64), _paper_model(easi_block_m=128)
    for name, model in (("a", a), ("b", b)):
        reg.register(name, model, model.init(torch.Generator().manual_seed(0)))
    assert reg.get("a").chash != reg.get("b").chash
    with pytest.raises(ValueError, match="already registered"):
        reg.register("a", b, b.init(torch.Generator().manual_seed(0)))
