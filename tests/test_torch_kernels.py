"""The port's kernel wrappers on CPU tensors (their plain versions) against
the JAX package's Pallas kernels in interpret mode and its jnp oracles.

The CUDA kernels themselves run only on the card; `chip_smoke.py` holds
them against these plain versions there."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import easi as j_easi
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.easi_update import easi_apply as pallas_easi_apply
from repro.kernels.fused_transform import fused_transform as pallas_fused_transform
from repro.kernels.ternary_matmul import ternary_matmul as pallas_ternary_matmul
from repro_torch import bridge
from repro_torch.core import easi as t_easi
from repro_torch.kernels import easi_update, fused_transform, ops, ref, ternary_matmul

TMM_SHAPES = [(1, 32, 24), (8, 32, 16), (37, 100, 9), (128, 256, 128), (256, 555, 77),
              (64, 1024, 256)]
FUSED_SHAPES = [(8, 32, 16, 8), (13, 32, 16, 8), (64, 33, 17, 9), (200, 100, 40, 10),
                (5, 7, 3, 2), (1, 32, 16, 8)]
EASI_SHAPES = [(1, 8, 32), (32, 16, 32), (8, 24, 24), (64, 7, 100), (128, 128, 512),
               (16, 100, 300)]
DTYPES = {"f32": (jnp.float32, 1e-5), "bf16": (jnp.bfloat16, 2e-2)}


def _ternary(rng, p, m):
    """Ternary int8 R (p, m) with the paper's density 1/p."""
    u = rng.random((p, m))
    return np.where(u < 0.5 / p, 1, np.where(u < 1.0 / p, -1, 0)).astype(np.int8)


def _pair(a, dtype):
    """The same values as a jax array and a CPU tensor (bf16 bits shared)."""
    j = jnp.asarray(a, dtype)
    return j, bridge.to_tensor(np.asarray(j), device="cpu")


def _close(got_t, want_j, tol):
    np.testing.assert_allclose(bridge.to_array(got_t),
                               np.asarray(want_j, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,m,p", TMM_SHAPES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_ternary_matmul_matches_pallas_and_oracle(b, m, p, dt):
    dtype, tol = DTYPES[dt]
    rng = np.random.default_rng(b * 1000 + m + p)
    xj, xt = _pair(rng.standard_normal((b, m)), dtype)
    r = _ternary(rng, p, m)
    got = ternary_matmul.ternary_matmul(xt, torch.from_numpy(r), scale=0.37)
    assert got.dtype == xt.dtype and tuple(got.shape) == (b, p)
    _close(got, pallas_ternary_matmul(xj, jnp.asarray(r), scale=0.37, interpret=True), tol)
    _close(got, j_ref.ternary_matmul_ref(xj, jnp.asarray(r), scale=0.37), tol)


def test_ternary_matmul_exact_on_integers():
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 8, (16, 64)).astype(np.float32)
    r = _ternary(rng, 32, 64)
    got = ops.ternary_matmul(torch.from_numpy(x), torch.from_numpy(r))
    want = pallas_ternary_matmul(jnp.asarray(x), jnp.asarray(r), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows,m,p,n", FUSED_SHAPES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_fused_transform_matches_pallas_and_oracle(rows, m, p, n, dt):
    dtype, tol = DTYPES[dt]
    rng = np.random.default_rng(rows + 7 * m)
    xj, xt = _pair(rng.standard_normal((rows, m)), dtype)
    bj, bt = _pair(rng.standard_normal((n, p)), dtype)
    r = _ternary(rng, p, m)
    got = fused_transform.fused_transform(xt, torch.from_numpy(r), bt, scale=0.37)
    assert got.dtype == bt.dtype and tuple(got.shape) == (rows, n)
    _close(got, pallas_fused_transform(xj, jnp.asarray(r), bj, scale=0.37, interpret=True),
           tol)
    _close(got, j_ref.fused_transform_ref(xj, jnp.asarray(r), bj, scale=0.37), tol)


def _ternary_s(rng, p, m, s):
    """Ternary int8 R (p, m) of density 1/s (s = 1: every entry is ±1)."""
    u = rng.random((p, m))
    return np.where(u < 0.5 / s, 1, np.where(u < 1.0 / s, -1, 0)).astype(np.int8)


# ragged rows, m and p: rows not a multiple of 32, m not of 32, p not of 8
# (rows, m, p, n): ragged everywhere; the second has rows past one 32-row
# tile, m past one 32-column chunk and n past one 64-column tile
DENSITY_SHAPES = [(37, 70, 21, 10), (70, 100, 40, 70)]


@pytest.mark.parametrize("shape", DENSITY_SHAPES)
@pytest.mark.parametrize("s", [1, 3, "p"])
@pytest.mark.parametrize("zero_rows", [False, True])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_fused_transform_at_densities(shape, s, zero_rows, dt):
    """The plain version (the card's oracle) against the Pallas kernel at
    density 1/s, down to s = 1, and with rows of R that are all zero.  bf16
    is held against the Pallas kernel only: the jnp oracle rounds its
    intermediate to x's dtype (ROADMAP C1)."""
    dtype, tol = DTYPES[dt]
    rows, m, p, n = shape
    rng = np.random.default_rng(100 + (p if s == "p" else s) + 7 * zero_rows + rows)
    xj, xt = _pair(rng.standard_normal((rows, m)), dtype)
    bj, bt = _pair(rng.standard_normal((n, p)) / np.sqrt(p), dtype)
    r = _ternary_s(rng, p, m, p if s == "p" else s)
    if zero_rows:
        r[::3] = 0
    got = fused_transform.fused_transform(xt, torch.from_numpy(r), bt, scale=0.37)
    assert got.dtype == bt.dtype and tuple(got.shape) == (rows, n)
    _close(got, pallas_fused_transform(xj, jnp.asarray(r), bj, scale=0.37, interpret=True),
           tol)
    if dt == "f32":
        _close(got, j_ref.fused_transform_ref(xj, jnp.asarray(r), bj, scale=0.37), tol)
    if zero_rows:   # a row of R that is all zero adds nothing
        r2 = r.copy()
        r2[::3] = 1
        moved = fused_transform.fused_transform(xt, torch.from_numpy(r2), bt, scale=0.37)
        assert not torch.equal(moved, got)


# (b, m, p, s, zero_rows): the two ragged density shapes at s = 1, 3 and p,
# with and without all-zero rows of R, then the shapes of chip_smoke.py's
# TMM_EDGE that interpret mode runs in seconds (the wide row at each density,
# ragged with zero rows, a single row, R at exactly 65536 entries, many row
# tiles on the dense side)
TMM_DENSITY_CASES = (
    [(b, m, p, s, z) for (b, m, p) in [(37, 70, 21), (70, 100, 40)] for s in (1, 3, "p")
     for z in (False, True)]
    + [(256, 1024, 256, "p", False), (256, 1024, 256, 3, False), (256, 1024, 256, 1, False),
       (77, 1000, 130, "p", True), (1, 1024, 256, "p", False), (33, 2048, 32, "p", False),
       (300, 2100, 70, 3, False), (256, 555, 77, "p", False), (4000, 32, 24, "p", False)])


@pytest.mark.parametrize("b,m,p,s,zero_rows", TMM_DENSITY_CASES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_ternary_matmul_at_densities(b, m, p, s, zero_rows, dt):
    """The plain version (the card's oracle) against the Pallas kernel and
    the jnp oracle at density 1/s, down to s = 1, and with rows of R that
    are all zero, at the model's scale sqrt(s / m) (RPConfig.scale)."""
    dtype, tol = DTYPES[dt]
    s = p if s == "p" else s
    rng = np.random.default_rng(200 + s + 7 * zero_rows + b + m)
    xj, xt = _pair(rng.standard_normal((b, m)), dtype)
    r = _ternary_s(rng, p, m, s)
    if zero_rows:
        r[::3] = 0
    scale = float(np.sqrt(s / m))
    got = ternary_matmul.ternary_matmul(xt, torch.from_numpy(r), scale=scale)
    assert got.dtype == xt.dtype and tuple(got.shape) == (b, p)
    _close(got, pallas_ternary_matmul(xj, jnp.asarray(r), scale=scale, interpret=True), tol)
    _close(got, j_ref.ternary_matmul_ref(xj, jnp.asarray(r), scale=scale), tol)
    if zero_rows:   # a row of R that is all zero gives a zero column of y
        assert not got[:, ::3].to(torch.float32).any()


def test_fused_transform_exact_on_integers():
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 8, (16, 64)).astype(np.float32)
    r = _ternary(rng, 32, 64)
    b = rng.integers(-4, 4, (8, 32)).astype(np.float32)
    got = ops.fused_transform(torch.from_numpy(x), torch.from_numpy(r), torch.from_numpy(b))
    want = pallas_fused_transform(jnp.asarray(x), jnp.asarray(r), jnp.asarray(b),
                                  interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _easi_inputs(seed, b, n, m, scale=0.3):
    rng = np.random.default_rng(seed)
    b_mat = (rng.standard_normal((n, m)) * scale).astype(np.float32)
    y = rng.standard_normal((b, n)).astype(np.float32)
    return b_mat, y


@pytest.mark.parametrize("b,n,m", EASI_SHAPES)
@pytest.mark.parametrize("so,ho", [(True, True), (True, False), (False, True)])
def test_easi_apply_matches_pallas_and_oracle(b, n, m, so, ho):
    b_mat, y = _easi_inputs(b + n * 31 + m * 7, b, n, m)
    kw = dict(mu=1e-3, second_order=so, higher_order=ho)
    got = easi_update.easi_apply(torch.from_numpy(b_mat), torch.from_numpy(y), **kw)
    want_p = pallas_easi_apply(jnp.asarray(b_mat), jnp.asarray(y), interpret=True, **kw)
    want_o = j_ref.easi_apply_ref(jnp.asarray(b_mat), jnp.asarray(y), **kw)
    for want in (want_p, want_o):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)


# (b, n, m, so, ho, g, zeros in Y): a single sample, n = 200, a ragged shape
# with each g, the wide row under each (so, ho), a long block, and n at the
# edge of the card's one-launch body and past it
EASI_EDGE_CASES = (
    [(1, 128, 256, True, True, "cubic", False),
     (33, 200, 300, True, True, "sign_cubic", True)]
    + [(300, 100, 77, True, True, g, False) for g in ("cubic", "tanh", "sign_cubic")]
    + [(256, 128, 256, so, ho, "cubic", False)
       for so, ho in [(True, True), (True, False), (False, True)]]
    + [(4000, 16, 24, False, True, "cubic", False), (32, 64, 100, True, True, "cubic", False),
       (32, 65, 100, True, True, "cubic", False)])


@pytest.mark.parametrize("b,n,m,so,ho,g_name,zeros", EASI_EDGE_CASES)
def test_easi_apply_edge_shapes(b, n, m, so, ho, g_name, zeros):
    b_mat, y = _easi_inputs(b + 3 * n + m, b, n, m)
    if zeros:
        y[:, ::5] = 0.0
    kw = dict(mu=1e-3, second_order=so, higher_order=ho, g_name=g_name)
    got = easi_update.easi_apply(torch.from_numpy(b_mat), torch.from_numpy(y), **kw)
    want_p = pallas_easi_apply(jnp.asarray(b_mat), jnp.asarray(y), interpret=True, **kw)
    want_o = j_ref.easi_apply_ref(jnp.asarray(b_mat), jnp.asarray(y), **kw)
    for want in (want_p, want_o):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("g_name", ["cubic", "tanh", "sign_cubic"])
def test_easi_apply_nonlinearities(g_name):
    b_mat, y = _easi_inputs(1, 32, 16, 48, scale=0.2)
    y[:3, :5] = 0.0                      # sign_cubic must give 0 at y = 0
    kw = dict(mu=5e-4, g_name=g_name)
    got = easi_update.easi_apply(torch.from_numpy(b_mat), torch.from_numpy(y), **kw)
    want_p = pallas_easi_apply(jnp.asarray(b_mat), jnp.asarray(y), interpret=True, **kw)
    want_o = j_ref.easi_apply_ref(jnp.asarray(b_mat), jnp.asarray(y), **kw)
    for want in (want_p, want_o):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)


def test_easi_apply_bf16():
    b_mat, y = _easi_inputs(2, 32, 16, 48, scale=0.2)
    bj, bt = _pair(b_mat, jnp.bfloat16)
    yj, yt = _pair(y, jnp.bfloat16)
    got = easi_update.easi_apply(bt, yt, mu=5e-4)
    assert got.dtype == torch.bfloat16
    _close(got, pallas_easi_apply(bj, yj, mu=5e-4, interpret=True), 2e-2)
    _close(got, j_ref.easi_apply_ref(bj, yj, mu=5e-4), 2e-2)


@pytest.mark.parametrize("normalized", [False, True])
def test_ops_easi_update_matches_reference_step(normalized):
    """ops.easi_update (y = h Bᵀ, then easi_apply) == the reference's
    kernel-path step, and the normalized variant stays on the plain path."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((32, 32)).astype(np.float32)
    j_cfg = j_easi.EASIConfig(m=32, n=16, mu=1e-3, normalized=normalized)
    t_cfg = t_easi.EASIConfig(m=32, n=16, mu=1e-3, normalized=normalized)
    b0 = np.array(j_easi.init_b(jax.random.PRNGKey(4), j_cfg))
    got = ops.easi_update(torch.from_numpy(b0), torch.from_numpy(x), t_cfg)
    want = j_ops.easi_update(jnp.asarray(b0), jnp.asarray(x), j_cfg, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)
    step, _ = j_easi.easi_step(jnp.asarray(b0), jnp.asarray(x), j_cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(step), rtol=2e-5, atol=2e-6)


def test_plain_versions_are_the_ref_module():
    assert ternary_matmul.plain is ref.ternary_matmul_ref
    assert fused_transform.plain is ref.fused_transform_ref
    assert easi_update.plain is ref.easi_apply_ref


def test_cpu_calls_leave_launch_counters_at_zero():
    for mod in (ternary_matmul, fused_transform, easi_update):
        mod.launches = 0
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32))
    r = torch.from_numpy(_ternary(rng, 16, 32))
    b = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    ops.ternary_matmul(x, r)
    ops.fused_transform(x, r, b)
    easi_update.easi_apply(b, x[:, :8], mu=1e-3)
    assert (ternary_matmul.launches, fused_transform.launches, easi_update.launches) == (0, 0, 0)


def test_wrappers_take_the_plain_path_only_for_cpu_tensors():
    """A tensor on any other device goes to the kernel checks and raises;
    nothing falls back to the plain version."""
    x = torch.zeros((4, 8), device="meta")
    r = torch.zeros((2, 8), dtype=torch.int8, device="meta")
    b = torch.zeros((3, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ternary_matmul.ternary_matmul(x, r)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_transform.fused_transform(x, r, b)
    with pytest.raises(ValueError, match="CUDA device"):
        easi_update.easi_apply(b, torch.zeros((5, 3), device="meta"), mu=1e-3)
