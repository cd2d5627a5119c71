"""The port's MoE (`repro_torch.models.blocks.moe_layer` and the MoE
transformers phi3.5-moe and dbrx) on CPU tensors against the JAX package.

The layer is held to `blocks.moe_layer` at high capacity, with capacity
drops, and at dbrx's top-4: the routing metadata first, exactly (the
chosen experts, the stable sort by expert, each choice's slot and whether
it is kept), so a flipped choice shows as a routing difference and not as
a tolerance miss; then the output and the aux losses.  The models' SMOKE
configs serve a prefill and 6 decode steps against JAX `api`
(`torch_lm_parity.serve_case`), in f32 (1e-4) and bf16 (2e-2)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models import blocks as j_blocks
from repro.models import transformer as j_transformer
from repro.models.config import MoESpec as JSpec
from repro_torch import bridge
from repro_torch.models import blocks as t_blocks
from repro_torch.models import transformer as t_transformer
from repro_torch.models.config import MoESpec as TSpec
from torch_lm_parity import CPU, CPU_KERNEL, TOL, close, configs, np_tree, request, serve_case

# (tokens, d, experts, d_ff, top_k, capacity factor): no drops (capacity
# >= T·k), drops at capacity factor 1, dbrx's top-4 of 8 experts
LAYER_CASES = {"high_capacity": (64, 16, 4, 32, 2, 4.0), "drops": (256, 8, 4, 16, 2, 1.0),
               "top4": (96, 16, 8, 24, 4, 1.25)}


def _layer_inputs(case, dtype, seed=0):
    t, d, e, f, k, cf = LAYER_CASES[case]
    rng = np.random.default_rng(seed)
    params = {"router": (rng.standard_normal((d, e)) * 0.1).astype(np.float32),
              "w_in": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
              "w_gate": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
              "w_out": (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32)}
    x = rng.standard_normal((2, t // 2, d)).astype(np.float32)
    # the expert weights in the compute dtype, as prefill's cast gives them;
    # the router stays f32 here (the layer reads it in f32 either way)
    jp = {n: jnp.asarray(a, jnp.float32 if n == "router" else dtype) for n, a in params.items()}
    jx = jnp.asarray(x, dtype)
    spec = dict(n_experts=e, top_k=k, d_ff_expert=f, capacity_factor=cf)
    return (jp, jx, JSpec(**spec)), (bridge.params_from_reference(np_tree(jp), device="cpu"),
                                     bridge.to_tensor(np.asarray(jx), device="cpu"),
                                     TSpec(**spec))


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_capacity_matches_the_reference(case):
    t, _, e, f, k, cf = LAYER_CASES[case]
    for n in (1, 2, 7, t, 4096, 4097):
        spec = dict(n_experts=e, top_k=k, d_ff_expert=f, capacity_factor=cf)
        assert t_blocks.moe_capacity(n, TSpec(**spec)) == j_blocks.moe_capacity(n, JSpec(**spec))


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_moe_routing_metadata_equals_the_reference(case, dt):
    (jp, jx, js), (tp, tx, ts) = _layer_inputs(case, dt)
    x2, tx2 = jx.reshape(-1, jx.shape[-1]), tx.reshape(-1, tx.shape[-1])
    se, stok, sw, pos, aux = j_blocks._route(x2, jp["router"], js)
    probs = jax.nn.softmax(x2.astype(jnp.float32) @ jp["router"], axis=-1)
    _, top_e = jax.lax.top_k(probs, js.top_k)
    r, t_aux = t_blocks._route(tx2, tp["router"], ts)
    c = t_blocks.moe_capacity(tx2.shape[0], ts)
    for name, got, want in (("top_e", r.top_e, top_e), ("se", r.se, se),
                            ("stok", r.stok, stok), ("pos", r.pos, pos),
                            ("keep", r.pos < c, np.asarray(pos) < c)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64),
                                      err_msg=name)
    close(r.sw, sw, 1e-6, "sw")
    for name in ("moe_lb", "moe_z"):
        close(t_aux[name], aux[name], TOL["float32"], name)
    dropped = int((r.pos >= c).sum())
    assert (dropped > 0) == (case == "drops"), dropped


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_moe_layer_matches_the_reference(case, dt):
    (jp, jx, js), (tp, tx, ts) = _layer_inputs(case, dt)
    want, aux = j_blocks.moe_layer(jp, jx, js, "silu")
    got, t_aux = t_blocks.moe_layer(tp, tx, ts, "silu")
    assert got.dtype == tx.dtype and got.shape == tx.shape
    close(got, want, TOL[dt], "y")
    for name in ("moe_lb", "moe_z"):
        close(t_aux[name], aux[name], TOL["float32"], name)


def test_moe_matches_a_dense_loop_at_high_capacity():
    """tests/test_blocks.py::TestMoE's dense check, on the port alone:
    with capacity >= T·k no token drops, and the sort dispatch equals a
    loop over (slot, expert)."""
    _, (tp, tx, ts) = _layer_inputs("high_capacity", "float32")
    y, aux = t_blocks.moe_layer(tp, tx, ts, "silu")
    x = tx.reshape(-1, tx.shape[-1])
    probs = torch.softmax(x @ tp["router"], dim=-1)
    topw, topi = torch.topk(probs, ts.top_k, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True)
    want = torch.zeros_like(x)
    for j in range(ts.top_k):
        for ei in range(ts.n_experts):
            h = t_blocks.act_fn("silu")(x @ tp["w_gate"][ei]) * (x @ tp["w_in"][ei])
            ye = h @ tp["w_out"][ei]
            want += torch.where((topi[:, j] == ei)[:, None], ye * topw[:, j:j + 1], 0.0)
    np.testing.assert_allclose(y.reshape(x.shape).numpy(), want.numpy(), rtol=2e-4, atol=2e-5)
    assert float(aux["moe_lb"]) > 0.5   # the load-balance loss is near 1 at init


def test_moe_repeats_bit_for_bit_and_drops_stay_bounded():
    """Two calls give the same bits (each token's contributions are summed
    in a fixed order); at capacity factor 1 most tokens are still routed."""
    _, (tp, tx, ts) = _layer_inputs("drops", "float32")
    y1, _ = t_blocks.moe_layer(tp, tx, ts, "silu")
    y2, _ = t_blocks.moe_layer(tp, tx, ts, "silu")
    assert torch.equal(y1, y2)
    assert bool(torch.isfinite(y1).all())
    assert float((y1.abs().sum(-1) > 0).to(torch.float32).mean()) > 0.5


# ---------------------------------------------------------------------------
# phi3.5-moe and dbrx SMOKE against JAX api
# ---------------------------------------------------------------------------

MOE_ARCHS = ["phi35_moe", "dbrx_132b"]


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_moe_prefill_and_decode_match_the_reference(arch_id, compute_dtype):
    serve_case(*configs(arch_id, compute_dtype), compute_dtype, CPU)


def test_dbrx_top4_prefill_and_decode_match_the_reference():
    """dbrx's own top-4 routing (its SMOKE config routes top-2)."""
    jc, _ = configs("dbrx_132b", "float32", moe=JSpec(n_experts=8, top_k=4, d_ff_expert=48))
    _, tc = configs("dbrx_132b", "float32", moe=TSpec(n_experts=8, top_k=4, d_ff_expert=48))
    serve_case(jc, tc, "float32", CPU)


def test_moe_kernel_backend_on_cpu_matches_the_reference():
    """backend="kernel" on CPU tensors: attention through the kernel
    wrapper's plain version, inside the MoE model."""
    serve_case(*configs("phi35_moe", "float32"), "float32", CPU_KERNEL)


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_moe_forward_and_aux_match_the_reference(arch_id):
    """The full forward's logits and its aux losses, averaged over layers."""
    jc, tc = configs(arch_id, "float32")
    params = j_transformer.init_params(jax.random.PRNGKey(6), jc)
    inputs, _, _ = request(jc, batch=3, decode_steps=0)
    want, aux = j_transformer.forward(params, {k: jnp.asarray(v) for k, v in inputs.items()},
                                      jc, remat=False)
    got, t_aux = t_transformer.forward(bridge.params_from_reference(np_tree(params), device="cpu"),
                                       {k: torch.from_numpy(v) for k, v in inputs.items()}, tc,
                                       execution=CPU)
    close(got, want, TOL["float32"], "logits")
    for name in ("moe_lb", "moe_z"):
        close(t_aux[name], aux[name], TOL["float32"], name)
    assert float(t_aux["moe_lb"]) > 0.5 and t_aux["n_prefix"] == aux["n_prefix"] == 0
