"""The port's core modules (random projection, EASI, whitening, Execution)
against the JAX package on the CPU.  Random draws cannot cross packages,
so every parity case imports the reference's R / B₀ through numpy; the
port's own samplers are tested for their distribution."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import easi as j_easi
from repro.core import random_projection as j_rp
from repro.core import whitening as j_white
from repro_torch import bridge
from repro_torch.core import easi as t_easi
from repro_torch.core import random_projection as t_rp
from repro_torch.core import whitening as t_white
from repro_torch.core.execution import Execution

CPU_TORCH = Execution(backend="torch", device="cpu")
CPU_KERNEL = Execution(backend="kernel", device="cpu")


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

class TestExecution:
    def test_defaults_and_validation(self):
        exe = Execution()
        assert (exe.backend, exe.device, exe.dtype) == ("torch", "cuda", torch.float32)
        assert Execution(backend="kernel").use_kernel and not exe.use_kernel
        with pytest.raises(ValueError, match="unknown backend"):
            Execution(backend="pallas")
        with pytest.raises(ValueError, match="tmm_block_k"):
            Execution(tmm_block_k=0)
        with pytest.raises(ValueError, match="unsupported device"):
            Execution(device="meta")

    def test_cpu_device_resolves(self):
        assert CPU_TORCH.torch_device() == torch.device("cpu")


# ---------------------------------------------------------------------------
# random projection
# ---------------------------------------------------------------------------

class TestRandomProjection:
    @pytest.mark.parametrize("m,p,s,norm", [(32, 24, None, "per_dim"), (32, 16, 4, "isometry"),
                                            (100, 9, None, None), (1024, 256, 64, "per_dim")])
    def test_config_scale_matches_reference(self, m, p, s, norm):
        t = t_rp.RPConfig(m=m, p=p, sparsity=s, normalize=norm)
        j = j_rp.RPConfig(m=m, p=p, sparsity=s, normalize=norm)
        assert (t.s, t.scale, t.expected_nonzeros(), t.bytes_int8(), t.bytes_f32()) == \
            (j.s, j.scale, j.expected_nonzeros(), j.bytes_int8(), j.bytes_f32())

    def test_config_checks(self):
        with pytest.raises(ValueError, match="increase"):
            t_rp.RPConfig(m=8, p=16)
        with pytest.raises(ValueError, match="sparsity"):
            t_rp.RPConfig(m=16, p=8, sparsity=0)
        with pytest.raises(ValueError, match="normalize"):
            t_rp.RPConfig(m=16, p=8, normalize="l2")

    def test_sample_ternary_distribution(self):
        cfg = t_rp.RPConfig(m=512, p=64)
        r = t_rp.sample_ternary(torch.Generator().manual_seed(0), cfg)
        assert r.dtype == torch.int8 and tuple(r.shape) == (64, 512)
        assert set(r.unique().tolist()) <= {-1, 0, 1}
        nnz = int((r != 0).sum())
        assert abs(nnz / r.numel() - 1 / cfg.s) < 0.2 / cfg.s
        assert abs(int((r == 1).sum()) - int((r == -1).sum())) < 4 * math.sqrt(nnz)

    def test_sample_ternary_plants_dead_rows(self):
        # paper scale: ~26% of rows would be empty without the plant
        cfg = t_rp.RPConfig(m=32, p=24)
        gen = torch.Generator().manual_seed(1)
        for _ in range(20):
            r = t_rp.sample_ternary(gen, cfg)
            assert bool((r != 0).any(dim=1).all())
        raw = torch.stack([t_rp.sample_ternary(gen, cfg, ensure_nonzero_rows=False)
                           for _ in range(20)])
        dead = float((raw == 0).all(dim=2).float().mean())
        assert abs(dead - (1 - 1 / 24) ** 32) < 0.1

    @pytest.mark.parametrize("norm", ["per_dim", "isometry", None])
    @pytest.mark.parametrize("exe", [None, CPU_KERNEL], ids=["dense", "kernel"])
    def test_apply_rp_on_imported_r(self, norm, exe):
        jc = j_rp.RPConfig(m=40, p=12, normalize=norm)
        tc = t_rp.RPConfig(m=40, p=12, normalize=norm)
        r = np.array(j_rp.sample_ternary(jax.random.PRNGKey(3), jc))
        x = _rand(4, 3, 5, 40)                       # leading batch dims kept
        got = t_rp.apply_rp(torch.from_numpy(r), torch.from_numpy(x), tc, execution=exe)
        want = j_rp.apply_rp(jnp.asarray(r), jnp.asarray(x), jc)
        assert tuple(got.shape) == (3, 5, 12)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    def test_apply_rp_bf16(self):
        jc = j_rp.RPConfig(m=32, p=16, dtype=jnp.bfloat16)
        tc = t_rp.RPConfig(m=32, p=16, dtype=torch.bfloat16)
        r = np.array(j_rp.sample_ternary(jax.random.PRNGKey(5), jc))
        x = _rand(6, 9, 32)
        got = t_rp.apply_rp(torch.from_numpy(r), torch.from_numpy(x), tc)
        want = j_rp.apply_rp(jnp.asarray(r), jnp.asarray(x), jc)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(bridge.to_array(got), np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)

    def test_rp_gram_error(self):
        jc = j_rp.RPConfig(m=64, p=32)
        tc = t_rp.RPConfig(m=64, p=32)
        r = np.array(j_rp.sample_ternary(jax.random.PRNGKey(7), jc))
        x = _rand(8, 20, 64)
        got = t_rp.rp_gram_error(torch.from_numpy(r), tc, torch.from_numpy(x))
        want = j_rp.rp_gram_error(jnp.asarray(r), jc, jnp.asarray(x))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# EASI
# ---------------------------------------------------------------------------

def _cfgs(**kw):
    return j_easi.EASIConfig(**kw), t_easi.EASIConfig(**kw)


class TestEASI:
    def test_config_checks(self):
        with pytest.raises(ValueError, match="increase"):
            t_easi.EASIConfig(m=4, n=8)
        with pytest.raises(ValueError, match="second_order"):
            t_easi.EASIConfig(m=8, n=4, second_order=False, higher_order=False)
        with pytest.raises(ValueError, match="nonlinearity"):
            t_easi.EASIConfig(m=8, n=4, g="relu")
        with pytest.raises(ValueError, match="init"):
            t_easi.EASIConfig(m=8, n=4, init="zeros")

    @pytest.mark.parametrize("init", ["eye", "strided"])
    @pytest.mark.parametrize("n,m", [(16, 32), (8, 32), (7, 24), (3, 100), (5, 5)])
    def test_deterministic_init_bitwise(self, init, n, m):
        jc, tc = _cfgs(m=m, n=n, init=init)
        got = t_easi.init_b(torch.Generator(), tc)
        want = j_easi.init_b(jax.random.PRNGKey(0), jc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_orthonormal_rows(self):
        _, tc = _cfgs(m=48, n=12)
        b = t_easi.init_b(torch.Generator().manual_seed(0), tc)
        assert tuple(b.shape) == (12, 48) and b.dtype == torch.float32
        np.testing.assert_allclose((b @ b.T).numpy(), np.eye(12), atol=1e-5)

    @pytest.mark.parametrize("so,ho", [(True, True), (True, False), (False, True)])
    @pytest.mark.parametrize("g", ["cubic", "tanh", "sign_cubic"])
    @pytest.mark.parametrize("normalized", [False, True])
    def test_relative_gradient(self, so, ho, g, normalized):
        jc, tc = _cfgs(m=16, n=6, g=g, second_order=so, higher_order=ho,
                       normalized=normalized, mu=1e-2)
        y = _rand(9, 10, 6)
        got = t_easi.relative_gradient(torch.from_numpy(y), tc)
        want = j_easi.relative_gradient(jnp.asarray(y), jc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    def test_relative_gradient_single_sample(self):
        jc, tc = _cfgs(m=8, n=4)
        y = _rand(10, 4)
        np.testing.assert_allclose(
            t_easi.relative_gradient(torch.from_numpy(y), tc).numpy(),
            np.asarray(j_easi.relative_gradient(jnp.asarray(y), jc)), rtol=1e-5, atol=1e-6)

    def test_easi_step(self):
        jc, tc = _cfgs(m=32, n=16, mu=1e-3)
        b0 = np.array(j_easi.init_b(jax.random.PRNGKey(4), jc))
        x = _rand(11, 32, 32)
        b1, y = t_easi.easi_step(torch.from_numpy(b0), torch.from_numpy(x), tc)
        jb1, jy = j_easi.easi_step(jnp.asarray(b0), jnp.asarray(x), jc)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(b1.numpy(), np.asarray(jb1), rtol=2e-5, atol=2e-6)

    @pytest.mark.parametrize("block", [1, 32])
    @pytest.mark.parametrize("exe", [None, CPU_KERNEL], ids=["torch", "kernel"])
    def test_easi_fit_trajectory(self, block, exe):
        jc, tc = _cfgs(m=16, n=8, mu=1e-3)
        b0 = np.array(j_easi.init_b(jax.random.PRNGKey(12), jc))
        x = _rand(13, 300, 16)          # 300 = 9 blocks of 32 + 12 dropped samples
        got = t_easi.easi_fit(torch.from_numpy(b0), torch.from_numpy(x), tc,
                              block_size=block, epochs=2, execution=exe)
        want = j_easi.easi_fit(jnp.asarray(b0), jnp.asarray(x), jc,
                               block_size=block, epochs=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-5)

    def test_easi_fit_drops_trailing_samples(self):
        _, tc = _cfgs(m=16, n=8, mu=1e-3)
        b0 = t_easi.init_b(torch.Generator().manual_seed(0), tc)
        x = torch.from_numpy(_rand(14, 100, 16))
        full = t_easi.easi_fit(b0, x, tc, block_size=32)
        cut = t_easi.easi_fit(b0, x[:96], tc, block_size=32)
        assert torch.equal(full, cut)

    def test_whiteness_kl_and_amari(self):
        y = _rand(15, 200, 6) @ _rand(16, 6, 6)
        np.testing.assert_allclose(float(t_easi.whiteness_kl(torch.from_numpy(y))),
                                   float(j_easi.whiteness_kl(jnp.asarray(y))), rtol=1e-4)
        w, a = _rand(17, 5, 9), _rand(18, 9, 5)
        np.testing.assert_allclose(
            float(t_easi.amari_distance(torch.from_numpy(w), torch.from_numpy(a))),
            float(j_easi.amari_distance(jnp.asarray(w), jnp.asarray(a))), rtol=1e-5)
        # a scaled permutation is a perfect separation
        perm = np.eye(5, dtype=np.float32)[[2, 0, 4, 1, 3]] * 3.0
        assert float(t_easi.amari_distance(torch.from_numpy(perm),
                                           torch.eye(5))) == pytest.approx(0.0, abs=1e-7)

    def test_transform(self):
        b, x = _rand(19, 4, 10), _rand(20, 2, 3, 10)
        np.testing.assert_allclose(
            t_easi.transform(torch.from_numpy(b), torch.from_numpy(x)).numpy(),
            np.asarray(j_easi.transform(jnp.asarray(b), jnp.asarray(x))), rtol=1e-6, atol=1e-6)


class TestWhitening:
    def test_delegates_to_easi(self):
        jc = j_white.whitening_config(16, 8, mu=1e-3)
        tc = t_white.whitening_config(16, 8, mu=1e-3)
        assert (tc.second_order, tc.higher_order) == (True, False)
        w0 = np.array(j_white.init_w(jax.random.PRNGKey(21), jc))
        x = _rand(22, 64, 16)
        got = t_white.whiten_fit(torch.from_numpy(w0), torch.from_numpy(x), tc, block_size=8)
        want = j_white.whiten_fit(jnp.asarray(w0), jnp.asarray(x), jc, block_size=8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-5)
        with pytest.raises(ValueError, match="HOS"):
            t_white.whiten_fit(torch.from_numpy(w0), torch.from_numpy(x),
                               t_easi.EASIConfig(m=16, n=8))
