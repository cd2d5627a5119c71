"""The paper's experiment on the port against the JAX package, on the CPU:
the mixtures, the AdamW optimizer, the MLP head, the two-stage pipeline,
the Waveform-V2 config, and the Table I / Table II / ICA experiments.

Random draws differ between the packages, so parity goes through imported
state: heads through `bridge.params_from_reference`, DR states through
`bridge.from_reference`, shuffles as the reference's own permutation.
Table I accuracy is held statistically, to the floors of
`tests/test_waveform_repro.py`, on the port's own draws."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import waveform_paper as j_wp
from repro.core import easi as j_easi
from repro.core import pipeline as j_pipeline
from repro.data import mixtures as j_mixtures
from repro.models import mlp as j_mlp
from repro.train import optimizer as j_opt
from repro_torch import bridge
from repro_torch.configs import waveform_paper as t_wp
from repro_torch.core import easi as t_easi
from repro_torch.core import pipeline as t_pipeline
from repro_torch.core.execution import Execution
from repro_torch.data import mixtures as t_mixtures
from repro_torch.data import waveform as t_waveform
from repro_torch.dr import EASIStage, RPStage
from repro_torch.experiments import ica_quality, table1_accuracy, table2_cost, waveform_repro
from repro_torch.models import mlp as t_mlp
from repro_torch.train import optimizer as t_opt

REPO = Path(__file__).resolve().parent.parent
CPU = Execution(device="cpu")
CPU_KERNEL = Execution(backend="kernel", device="cpu")
TRAJ = dict(rtol=5e-4, atol=5e-5)      # the reference's trajectory bound
OPT_TOL = dict(rtol=1e-6, atol=1e-7)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# data/mixtures.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n_samples=500, m=8, n_src=4, seed=0),
    dict(n_samples=300, m=6, n_src=6, seed=3, kinds=["uniform", "bimodal", "sine"]),
    dict(n_samples=200, m=16, n_src=4, seed=1, noise=0.1),
])
def test_mixture_arrays_equal_the_reference(kw):
    for got, want in zip(t_mixtures.mixture(**kw), j_mixtures.mixture(**kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# train/optimizer.py
# ---------------------------------------------------------------------------

def _opt_params(rng):
    return {"layers": [{"w": rng.standard_normal((5, 4)).astype(np.float32),
                        "b": rng.standard_normal((4,)).astype(np.float32)},
                       {"w": rng.standard_normal((4, 3)).astype(np.float32),
                        "b": rng.standard_normal((3,)).astype(np.float32)}],
            "scale": rng.standard_normal((3,)).astype(np.float32)}


OPT_CASES = {
    "plain": dict(lr=1e-2, grad_clip=None),
    "clip": dict(lr=1e-2, grad_clip=0.5),
    "warmup_cosine": dict(lr=3e-2, grad_clip=1.0, warmup_steps=2, total_steps=6,
                          min_ratio=0.2),
    "decay": dict(lr=1e-2, grad_clip=None, weight_decay=0.1),
    "decay_mask": dict(lr=1e-2, grad_clip=None, weight_decay=0.1),
}


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("case", list(OPT_CASES))
def test_apply_updates_matches_reference(case, steps):
    rng = np.random.default_rng(7)
    params = _opt_params(rng)
    cfg_kw = OPT_CASES[case]
    jcfg, tcfg = j_opt.AdamWConfig(**cfg_kw), t_opt.AdamWConfig(**cfg_kw)
    mask = None
    if case == "decay_mask":   # decay the biases and nothing else
        mask = {"layers": [{"w": False, "b": True}, {"w": False, "b": True}], "scale": True}
    jp = jax.tree.map(jnp.asarray, params)
    tp = bridge.params_from_reference(params, device="cpu")
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for _ in range(steps):
        grads = jax.tree.map(lambda p: (3.0 * rng.standard_normal(p.shape)).astype(np.float32),
                             params)
        jp, js, jm = j_opt.apply_updates(jp, jax.tree.map(jnp.asarray, grads), js, jcfg,
                                         decay_mask=mask)
        tp, ts, tm = t_opt.apply_updates(tp, bridge.params_from_reference(grads, device="cpu"),
                                         ts, tcfg, decay_mask=mask)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == steps
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        got_l, want_l = t_opt.tree_leaves(bridge.params_to_numpy(got)), jax.tree.leaves(want)
        assert len(got_l) == len(want_l)
        for g, w in zip(got_l, want_l):
            np.testing.assert_allclose(g, np.asarray(w), **OPT_TOL)


@pytest.mark.parametrize("cfg_kw", [dict(), dict(warmup_steps=4), dict(total_steps=20),
                                    dict(warmup_steps=3, total_steps=12, min_ratio=0.05)])
def test_schedule_matches_reference(cfg_kw):
    jcfg, tcfg = j_opt.AdamWConfig(**cfg_kw), t_opt.AdamWConfig(**cfg_kw)
    for step in range(0, 25, 3):
        np.testing.assert_allclose(float(t_opt.schedule(tcfg, torch.tensor(step))),
                                   float(j_opt.schedule(jcfg, jnp.asarray(step))), rtol=1e-6)


def test_global_norm_and_clip_match_reference():
    params = _opt_params(np.random.default_rng(3))
    tree = bridge.params_from_reference(params, device="cpu")
    np.testing.assert_allclose(float(t_opt.global_norm(tree)),
                               float(j_opt.global_norm(params)), rtol=1e-6)
    clipped, norm = t_opt.clip_by_global_norm(tree, 0.3)
    j_clipped, j_norm = j_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, params), 0.3)
    np.testing.assert_allclose(float(norm), float(j_norm), rtol=1e-6)
    for g, w in zip(t_opt.tree_leaves(bridge.params_to_numpy(clipped)),
                    jax.tree.leaves(j_clipped)):
        np.testing.assert_allclose(g, np.asarray(w), **OPT_TOL)


def test_default_decay_mask_spares_vectors():
    """Weight decay alone (zero gradients) moves matrices, never vectors."""
    tree = {"w": torch.ones((3, 2)), "b": torch.ones((2,))}
    zeros = t_opt.tree_map(torch.zeros_like, tree)
    new, _, _ = t_opt.apply_updates(tree, zeros, t_opt.init(tree),
                                    t_opt.AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip=None))
    assert torch.equal(new["b"], tree["b"])
    assert bool((new["w"] < 1.0).all())


# The reference's optimizer property tests (tests/test_properties.py:44-65).
try:
    from hypothesis import given, settings, strategies as st
except ImportError:   # hypothesis not installed (offline env)
    st = None


if st is not None:
    class TestOptimizerInvariants:
        @settings(max_examples=10, deadline=None)
        @given(lr=st.floats(1e-4, 1e-1), dim=st.integers(2, 32))
        def test_adamw_descends_quadratic(self, lr, dim):
            cfg = t_opt.AdamWConfig(lr=lr, grad_clip=None, weight_decay=0.0)
            params = {"w": torch.ones((dim,), dtype=torch.float32) * 3.0}
            state = t_opt.init(params)
            loss = lambda p: 0.5 * torch.sum(p["w"] ** 2)
            l0 = float(loss(params))
            for _ in range(20):
                g = {"w": params["w"].clone()}        # d/dw of 0.5·|w|²
                params, state, _ = t_opt.apply_updates(params, g, state, cfg)
            assert float(loss(params)) < l0

        @settings(max_examples=10, deadline=None)
        @given(scale=st.floats(1.0, 1e4))
        def test_grad_clip_bounds_update(self, scale):
            grads = {"w": torch.full((64,), scale, dtype=torch.float32)}
            clipped, norm = t_opt.clip_by_global_norm(grads, 1.0)
            cn = float(t_opt.global_norm(clipped))
            assert cn <= 1.0 + 1e-4


# ---------------------------------------------------------------------------
# models/mlp.py
# ---------------------------------------------------------------------------

def _heads(d_in=6, hidden=(8, 8), n_classes=3, seed=0):
    j_head = j_mlp.init(jax.random.PRNGKey(seed), d_in, hidden, n_classes)
    return j_head, bridge.params_from_reference(_np(j_head), device="cpu")


def _xy(n=200, d=6, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.integers(0, 3, size=n).astype(np.int32))


def test_mlp_init_layout_and_he_scale():
    head = t_mlp.init(torch.Generator().manual_seed(0), 400, (300,), 3, device="cpu")
    j_head = j_mlp.init(jax.random.PRNGKey(0), 400, (300,), 3)
    assert jax.tree.structure(_np(j_head)) == jax.tree.structure(bridge.params_to_numpy(head))
    for got, want in zip(jax.tree.leaves(bridge.params_to_numpy(head)), jax.tree.leaves(j_head)):
        assert got.shape == want.shape and got.dtype == want.dtype
    w = head["layers"][0]["w"]
    assert abs(float(w.std()) - (2.0 / 400) ** 0.5) < 0.003
    assert abs(float(w.mean())) < 0.003
    assert not bool(head["layers"][0]["b"].any())


def test_mlp_apply_loss_and_grads_match_reference():
    j_head, t_head = _heads()
    x, y = _xy()
    np.testing.assert_allclose(t_mlp.apply(t_head, torch.from_numpy(x)).numpy(),
                               np.asarray(j_mlp.apply(j_head, x)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(t_mlp.loss_fn(t_head, torch.from_numpy(x),
                                                   torch.from_numpy(y))),
                               float(j_mlp.loss_fn(j_head, x, y)), rtol=1e-5)
    g_t = t_mlp.grad(t_head, torch.from_numpy(x), torch.from_numpy(y))
    g_j = jax.grad(j_mlp.loss_fn)(j_head, x, y)
    for got, want in zip(t_opt.tree_leaves(bridge.params_to_numpy(g_t)), jax.tree.leaves(g_j)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [300, 256, 130])
def test_train_epoch_over_the_reference_permutation(n):
    """One epoch of the reference's `fit` (its first permutation) against the
    port's `train_epoch` over the same permutation: steps_per_epoch =
    n // batch, the tail dropped."""
    j_head, t_head = _heads()
    x, y = _xy(n)
    key = jax.random.PRNGKey(5)
    j_fit = j_mlp.fit(j_head, x, y, epochs=1, batch=64, key=key)
    _, k = jax.random.split(key)
    perm = torch.from_numpy(np.asarray(jax.random.permutation(k, n)).astype(np.int64))
    cfg = t_opt.AdamWConfig(lr=5e-4, grad_clip=None, weight_decay=1e-2)
    t_fit, state = t_mlp.train_epoch(t_head, t_opt.init(t_head), torch.from_numpy(x),
                                     torch.from_numpy(y), perm, cfg, batch=64)
    assert int(state.step) == n // 64
    for got, want in zip(t_opt.tree_leaves(bridge.params_to_numpy(t_fit)),
                         jax.tree.leaves(j_fit)):
        np.testing.assert_allclose(got, np.asarray(want), **TRAJ)


def test_mlp_fit_learns_and_accuracy_matches_argmax():
    x, _ = _xy(512)
    y = (x[:, 0] > 0).astype(np.int64) + (x[:, 1] > 0.5)
    head = t_mlp.init(torch.Generator().manual_seed(0), 6, (16,), 3, device="cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    before = t_mlp.accuracy(head, xt, yt)
    head = t_mlp.fit(head, xt, yt, lr=1e-2, epochs=20, batch=64,
                     generator=torch.Generator().manual_seed(1))
    after = t_mlp.accuracy(head, xt, yt)
    assert after > max(before, 0.85)
    want = float((t_mlp.apply(head, xt).argmax(-1) == yt).float().mean())
    assert after == want


# ---------------------------------------------------------------------------
# core/pipeline.py
# ---------------------------------------------------------------------------

def test_center_global_scale_and_standardize_match_reference():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((300, 7)) * np.arange(1, 8) + 3.0).astype(np.float32)
    xt = torch.from_numpy(x)
    for t_fn, j_fn in ((t_pipeline.center_global_scale, j_pipeline.center_global_scale),
                       (t_pipeline.standardize, j_pipeline.standardize)):
        got, t_stats = t_fn(xt)
        want, j_stats = j_fn(jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        for g, w in zip(t_stats, j_stats):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
        # the stats carried across (as numpy) give the same transform
        again, _ = t_fn(xt[:50], tuple(np.asarray(s) for s in j_stats))
        np.testing.assert_allclose(again.numpy(), np.asarray(want)[:50], rtol=1e-6, atol=1e-6)


def test_generators_are_fixed_and_distinct():
    a = [g.initial_seed() for g in t_pipeline.generators(0)]
    b = [g.initial_seed() for g in t_pipeline.generators(0)]
    c = [g.initial_seed() for g in t_pipeline.generators(1)]
    assert a == b and len(set(a)) == 3 and set(a).isdisjoint(c)
    assert all(g.device.type == "cpu" for g in t_pipeline.generators(0))


def _paper_data(n_train=800, n_test=300):
    (xtr, ytr), (xte, yte) = t_waveform.paper_split(seed=0)
    return xtr[:n_train], ytr[:n_train], xte[:n_test], yte[:n_test]


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("row", ["easi_n8", "rp16_easi_n8", "rp24_easi_n16"])
def test_predict_and_evaluate_on_a_reference_fitted_model(row, backend):
    """The reference's fitted two-stage model carried across (DR state
    through `from_reference`, head through `params_from_reference`, stats
    as numpy) predicts the same logits and the same accuracy."""
    xtr, ytr, xte, yte = _paper_data()
    j_cfg = dataclasses.replace(j_wp.TABLE1_ROWS[row], dr_epochs=1, head_epochs=2)
    fitted = j_pipeline.fit_two_stage(j_cfg, jnp.asarray(xtr), jnp.asarray(ytr))
    t_cfg = dataclasses.replace(t_wp.TABLE1_ROWS[row], dr_epochs=1, head_epochs=2)
    exe = Execution(backend=backend, device="cpu")
    carried = {
        "dr_model": t_cfg.dr.with_execution(exe),
        "dr_state": bridge.from_reference(fitted["dr_state"], device="cpu"),
        "head": bridge.params_from_reference(_np(fitted["head"]), device="cpu"),
        "dr_stats": tuple(np.asarray(s) for s in fitted["dr_stats"]),
        "head_stats": tuple(np.asarray(s) for s in fitted["head_stats"]),
        "cfg": t_cfg,
    }
    t_logits = t_pipeline.predict(carried, xte).numpy()
    j_logits = np.asarray(j_pipeline.predict(fitted, jnp.asarray(xte)))
    np.testing.assert_allclose(t_logits, j_logits, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(t_logits.argmax(-1), j_logits.argmax(-1))
    # the same share right (the two means may round the last bit apart)
    assert abs(t_pipeline.evaluate(carried, xte, yte) -
               j_pipeline.evaluate(fitted, jnp.asarray(xte), jnp.asarray(yte))) < 1e-6


def test_fit_two_stage_kernel_backend_equals_torch_on_the_cpu():
    """On the CPU the kernel backend runs the kernels' plain versions, from
    the same draws: the same model to the trajectory bound."""
    xtr, ytr, xte, yte = _paper_data(640, 200)
    cfg = dataclasses.replace(t_wp.TABLE1_ROWS["rp16_easi_n8"], dr_epochs=2, head_epochs=2)
    a = t_pipeline.fit_two_stage(cfg, xtr, ytr, execution=CPU)
    b = t_pipeline.fit_two_stage(cfg, xtr, ytr, execution=CPU_KERNEL)
    assert torch.equal(a["dr_state"].r, b["dr_state"].r)
    np.testing.assert_allclose(b["dr_state"].b.numpy(), a["dr_state"].b.numpy(), **TRAJ)
    np.testing.assert_allclose(t_pipeline.predict(b, xte).numpy(),
                               t_pipeline.predict(a, xte).numpy(), rtol=1e-3, atol=1e-3)


def test_fit_two_stage_is_a_function_of_the_seed():
    xtr, ytr, _, _ = _paper_data(640, 10)
    cfg = dataclasses.replace(t_wp.TABLE1_ROWS["rp16_easi_n8"], dr_epochs=1, head_epochs=1)
    a, b = (t_pipeline.fit_two_stage(cfg, xtr, ytr, execution=CPU) for _ in range(2))
    c = t_pipeline.fit_two_stage(dataclasses.replace(cfg, seed=1), xtr, ytr, execution=CPU)
    assert torch.equal(a["dr_state"].b, b["dr_state"].b)
    assert torch.equal(a["head"]["layers"][0]["w"], b["head"]["layers"][0]["w"])
    assert not torch.equal(a["dr_state"].b, c["dr_state"].b)


def test_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    xtr, ytr, _, _ = _paper_data(64, 10)
    cfg = dataclasses.replace(t_wp.TABLE1_ROWS["rp16_easi_n8"], dr_epochs=1, head_epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_pipeline.fit_two_stage(cfg, xtr, ytr)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mlp.init(torch.Generator(), 4, (8,), 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ica_quality.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        waveform_repro.main(["--seeds", "1", "--fast", "--skip-ablations"])


# ---------------------------------------------------------------------------
# configs/waveform_paper.py
# ---------------------------------------------------------------------------

def _stage_fields(stage):
    return type(stage).__name__, {k: v for k, v in dataclasses.asdict(stage).items()
                                  if k != "dtype"}


def _model_fields(model):
    return [_stage_fields(s) for s in model.stages], model.block_size


@pytest.mark.parametrize("table", ["TABLE1_ROWS", "ABLATION_ROWS", "CASCADE_ROWS",
                                   "TABLE2_PAIR"])
def test_waveform_paper_rows_equal_the_reference(table):
    t_rows, j_rows = getattr(t_wp, table), getattr(j_wp, table)
    assert list(t_rows) == list(j_rows)
    for name in t_rows:
        t_row, j_row = t_rows[name], j_rows[name]
        if table == "TABLE2_PAIR":
            assert _model_fields(t_row) == _model_fields(j_row)
            continue
        assert _model_fields(t_row.dr) == _model_fields(j_row.dr)
        t_rest = {k: v for k, v in dataclasses.asdict(t_row).items() if k != "dr"}
        j_rest = {k: v for k, v in dataclasses.asdict(j_row).items() if k != "dr"}
        assert t_rest == j_rest
    assert t_wp.PAPER_TABLE1 == j_wp.PAPER_TABLE1 and t_wp.M == j_wp.M == 32


def test_waveform_paper_rows_run_on_the_card_by_default():
    for cfg in t_wp.TABLE1_ROWS.values():
        assert cfg.dr.execution.device == "cuda" and cfg.dr.execution.backend == "torch"


# ---------------------------------------------------------------------------
# the experiments: Table II, ICA quality, Table I
# ---------------------------------------------------------------------------

def _reference_table2():
    spec = importlib.util.spec_from_file_location("reference_table2_cost",
                                                  REPO / "benchmarks" / "table2_cost.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_table2_rows_equal_the_reference():
    got, want = table2_cost.run(), _reference_table2().run()
    assert [(n, d) for n, _, d in got] == [(n, d) for n, _, d in want]
    by_name = dict((n, d) for n, _, d in got)
    assert "ratio=1.94" in by_name["table2/mac_ratio_paper_row"]
    assert "ratio=2.00" in by_name["table2/weight_bytes_ratio"]
    for p, r in ((24, "1.34"), (16, "1.94"), (8, "3.53")):
        assert f"mac_ratio={r}" in by_name[f"table2/scaling_p{p}"]


@pytest.mark.parametrize("model", ["easi", "chain", "cascade", "table2_pair"])
def test_cost_row_equals_the_reference(model):
    import repro.dr as jdr
    from repro_torch import dr as tdr

    ref = _reference_table2()

    def build(pkg):
        if model == "easi":
            return [pkg.DRModel(stages=(pkg.EASIStage.full(32, 8),))]
        if model == "chain":
            return [pkg.DRModel(stages=(pkg.RPStage(32, 16), pkg.EASIStage.rotation(16, 8)))]
        if model == "cascade":
            return [pkg.DRModel(stages=(pkg.RPStage(32, 24), pkg.EASIStage.whiten(24, 16),
                                        pkg.EASIStage.rotation(16, 8)))]
        wp = t_wp if pkg is tdr else j_wp
        return list(wp.TABLE2_PAIR.values())

    for t_model, j_model in zip(build(tdr), build(jdr)):
        assert table2_cost.cost_row(t_model) == ref.cost_row(j_model)


@pytest.mark.parametrize("block,epochs", [(1, 1), (8, 2), (32, 4)])
def test_ica_amari_on_an_imported_b0(block, epochs):
    x, a = ica_quality.data(3000)
    j_cfg = j_easi.EASIConfig(m=6, n=6, mu=2e-3)
    b0 = j_easi.init_b(jax.random.PRNGKey(1), j_cfg)
    b = j_easi.easi_fit(b0, jnp.asarray(x), j_cfg, block_size=block, epochs=epochs)
    want = float(j_easi.amari_distance(b, jnp.asarray(a)))
    for exe in (CPU, CPU_KERNEL):
        got = ica_quality.amari_after_fit(bridge.to_tensor(np.asarray(b0), "cpu"),
                                          torch.from_numpy(x), torch.from_numpy(a),
                                          block=block, epochs=epochs, execution=exe)
        assert abs(got - want) < 1e-3, (got, want)


def test_ica_quality_rows():
    rows = ica_quality.run(fast=True, execution=CPU)
    assert [n for n, _, _ in rows] == [f"ica/amari_block{b}" for b, _ in ica_quality.BLOCKS]
    for _, us, detail in rows:
        amari = float(detail.split("=")[1])
        assert us > 0 and 0 <= amari < 0.05, detail


def test_table1_accuracy_rows():
    rows = table1_accuracy.run(fast=True, execution=CPU)
    assert [n for n, _, _ in rows] == [f"table1/{k}" for k in t_wp.TABLE1_ROWS]
    for (name, us, detail), row in zip(rows, t_wp.TABLE1_ROWS):
        acc = float(detail.split("acc=")[1].split("%")[0])
        assert us > 0 and 55.0 < acc <= 100.0, detail
        assert detail.endswith(f"paper={t_wp.PAPER_TABLE1[row]}")


def test_waveform_repro_main_and_ideal_pca(capsys):
    rows = waveform_repro.main(["--seeds", "1", "--fast", "--skip-ablations",
                                "--device", "cpu", "--backend", "kernel"])
    out = capsys.readouterr().out
    assert set(rows) == set(t_wp.TABLE1_ROWS) and "claim check" in out
    (xtr, ytr), (xte, yte) = t_waveform.paper_split(seed=0)
    acc = waveform_repro.ideal_pca_reference(xtr, ytr, xte, yte, 8, execution=CPU)
    assert acc > 75.0


def test_quickstart_separates_sources(capsys):
    from repro_torch.experiments import quickstart

    out = quickstart.main(["--device", "cpu"])
    assert out["amari"] < 0.05 and max(out["amari_models"]) < 0.05
    assert "MACs/sample" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Table I on the port's own draws: tests/test_waveform_repro.py's checks
# ---------------------------------------------------------------------------

_ACCS = {}


def _run(name, dr_epochs=None, head_epochs=12):
    """tests/test_waveform_repro.py's `_run` on the port's CPU path."""
    key = (name, dr_epochs, head_epochs)
    if key not in _ACCS:
        (xtr, ytr), (xte, yte) = t_waveform.paper_split(seed=0)
        c = dataclasses.replace(t_wp.TABLE1_ROWS[name], head_epochs=head_epochs)
        if dr_epochs is not None:
            c = dataclasses.replace(c, dr_epochs=dr_epochs)
        model = t_pipeline.fit_two_stage(c, xtr, ytr, execution=CPU)
        b = model["dr_state"].b
        assert bool(torch.isfinite(b).all()), "DR training diverged"
        _ACCS[key] = t_pipeline.evaluate(model, xte, yte)
    return _ACCS[key]


def test_table1_easi_n16():
    acc = _run("easi_n16")
    assert acc > 0.74, acc


def test_table1_rp_easi_n16():
    acc = _run("rp24_easi_n16", dr_epochs=10)
    assert acc > 0.72, acc


def test_table1_easi_n8():
    acc = _run("easi_n8")
    assert acc > 0.62, acc


def test_table1_rp_easi_n8():
    acc = _run("rp16_easi_n8", dr_epochs=10)
    assert acc > 0.65, acc


def test_claim_rp_easi_close_to_easi_initmatched():
    a_easi = _run("easi_n16")
    a_chain = _run("rp24_easi_n16", dr_epochs=10)
    assert abs(a_easi - a_chain) < 0.08, (a_easi, a_chain)
