"""The `zamba2-7b.prefill-4k` cell at smoke sizes on the CPU, through the
harness as the benchmark runs it (`bench.run_cell`, the device's look aside,
the port's kernel backend on its plain versions), and its configuration's
files: the family's sizes and counts at published widths, the config file
against the catalog's numbers, the reference's imports, the program's new
spans, and the four ablation faults (the reference with a mechanism left
out) against the cell's committed limits."""

import json
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from portbench import arch, bench, calibrate, flops
from portbench.families import zamba as family
from portbench.tests import smoke

CELL = "zamba2-7b.prefill-4k"
CONFIG = smoke.ROOT / "portbench" / "configs" / "zamba2-7b.json"

# every mechanism at a tiny width: 7 layers with uses at 1, 3, 5 of 2 blocks,
# 2 heads of Dh 2·d / heads scaled by (Dh / 2)^-1/2, 2 SSD groups; two
# SSD_CHUNKs of prompt, so the block form runs
ARCH = dict(n_layers=7, d_model=64, n_heads=2, n_kv_heads=2, head_dim=64, d_ff=96, vocab_size=256,
            d_state=8, ssm_head_dim=16, hybrid_layer_ids=[1, 3, 5], adapter_rank=4,
            q_chunk=32, kv_chunk=32, compute_dtype="float32")
TRAFFIC = dict(text_tokens=128, pool=4, sample_every=2, warmup=1, trace_requests=2)
FAULTS = ("adapters", "block0", "one_group", "norm_then_gate")


def run(*, fault=None, trace=False, seconds=0.5):
    over = dict(ARCH, **({"ablate": [fault]} if fault else {}))
    return bench.run_cell(smoke.ROOT, CELL, smoke.SEED, seconds, trace, device=smoke.CPU,
                          arch_overrides=over, traffic_overrides=TRAFFIC, log=lambda s: None)


def test_the_config_file_holds_the_catalog_s_numbers_and_the_arch_reads_them():
    cfg = arch.read(CONFIG)
    a = cfg["arch"]
    assert (a["n_layers"], a["d_model"], a["d_ff"], a["vocab_size"]) == (
        cfg["num_hidden_layers"], cfg["hidden_size"], cfg["ffn_hidden_size"], cfg["vocab_size"])
    assert (a["n_heads"], a["n_kv_heads"], a["head_dim"]) == (
        cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["attention_head_dim"])
    assert a["head_dim"] * a["n_heads"] == cfg["attention_hidden_size"] == 2 * a["d_model"]
    assert (a["d_state"], a["d_conv"], a["expand"], a["ssm_head_dim"], a["n_groups"]) == (
        cfg["mamba_d_state"], cfg["mamba_d_conv"], cfg["mamba_expand"], cfg["mamba_headdim"],
        cfg["mamba_ngroups"])
    assert a["expand"] * a["d_model"] // a["ssm_head_dim"] == cfg["n_mamba_heads"]
    assert (a["hybrid_layer_ids"], a["n_blocks"], a["adapter_rank"]) == (
        cfg["hybrid_layer_ids"], cfg["num_mem_blocks"], cfg["adapter_rank"])
    assert [i for i, t in enumerate(cfg["layers_block_type"]) if t == "hybrid"] == \
        a["hybrid_layer_ids"]
    assert (a["rope_theta"], a["norm_eps"]) == (cfg["rope_theta"], cfg["rms_norm_eps"])
    assert cfg["use_shared_mlp_adapter"] and not cfg["use_shared_attention_adapter"]
    assert cfg["changed_from_source"] == {} and cfg["port_overrides"] == []


def test_the_family_s_counts_at_published_sizes():
    a = arch.sizes(arch.read(CONFIG)["arch"])
    assert sum(int(torch.tensor(shape).prod()) for _, shape, _ in family.leaf_specs(a)) == \
        7_356_749_648 == arch.port_config(a).param_count()
    mamba, use = family.product_params(a)
    # 21.8 GFLOP of products a token, 42 % of them the 13 uses
    per_token = 2.0 * (a.n_layers * mamba + len(a.hybrid_layer_ids) * use)
    assert round(per_token / 1e9, 1) == 21.8
    assert round(2.0 * 13 * use / per_token, 2) == 0.42
    attn = family._attention(a, 1, 4096) / 4096
    assert round(attn / 1e9, 2) == 0.76
    request = flops.prefill_flops(a, 1, 4096, 0)
    assert 92e12 < request < 94e12
    assert request == pytest.approx(4096 * family._per_token(a) + family._attention(a, 1, 4096)
                                    + 2 * a.d_model * a.padded_vocab)
    # B4 at Dh 224 is bound by its operations: 4 · pairs · Dh · heads at the bf16 peak
    bound = flops.flash_bound_s(a, 1, 4096, lse=False)
    assert bound == pytest.approx(4 * 4096 * 4097 / 2 * 224 * 32 / flops.PEAK_BF16_FLOPS)
    assert flops.decode_flops(a, 1, 4096, 1) == pytest.approx(
        family._per_token(a) + 2 * a.d_model * a.padded_vocab + 4 * 4097 * 224 * 32 * 13)


def test_the_reference_loads_nothing_of_the_port():
    code = (f"import json, sys; sys.path.insert(0, {str(smoke.ROOT)!r}); "
            "import portbench.reference.zamba; print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(smoke.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    tops = {m.split(".", 1)[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


@pytest.mark.parametrize("fault", (None,) + FAULTS)
def test_each_ablation_fails_the_cell_s_check(fault):
    res, checks = run(fault=fault)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(checks) == {"logits"}
    assert res["correct"] is (fault is None), checks
    assert set(res["metrics"]) == {"serve_tokens_per_s", "latency_p95_ms", "setup_s"}


def test_a_traced_run_opens_the_spans_and_the_device_readers_stay_silent_on_the_cpu():
    from repro_torch import obs

    obs.clear()
    res, _ = run(trace=True, seconds=0.1)
    assert res["correct"]
    # each traced request: every layer's SSD scan, every use of a shared block
    a = arch.sizes(dict(arch.read(CONFIG)["arch"], **ARCH))
    assert obs.totals("ssm.ssd").count == TRAFFIC["trace_requests"] * a.n_layers
    assert obs.totals("zamba.shared").count == \
        TRAFFIC["trace_requests"] * len(a.hybrid_layer_ids)
    # no device events on the CPU: a device metric is never read from a CPU run
    manifest, cell = bench.resolve(smoke.ROOT, CELL)[:2]
    device = {m["name"] for m in bench.layer_metrics(manifest, cell)
              if m["source"] == "device_trace"}
    assert device and not device & set(res["metrics"]), device & set(res["metrics"])
    assert res["metrics"]["step_host_ms.serve"]["value"] > 0


def test_the_control_reads_far_above_the_program():
    _, program = run()
    control = dict(calibrate.control(smoke.ROOT, CELL, smoke.SEED, device=smoke.CPU,
                                     arch_overrides=ARCH, traffic_overrides=TRAFFIC, issued=12))
    assert set(control) == {"logits"}
    assert control["logits"] > 100 * program["logits"]["value"]
