"""The port's launch tooling against the JAX package: the dry run's shape
cells (`models/api.py`), the roofline's ring model and report
(`launch/roofline.py`), the dry run itself (`launch/dryrun.py`) on fake
tensors against the same step run for real, on fake meshes against the
reference's sharding arithmetic, the kernels' fake-tensor branch, and
`launch/{report,rescore}.py`.

Fake against real is exact: the same SMOKE step built on fake CPU tensors
and run on real ones gives the same FLOP count, byte count and
`MemTracker` peak (the kernel wrappers run their plain versions on CPU
tensors, fake or real).  State bytes on a mesh equal the arithmetic over
the reference's own specs, exactly."""

import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs import registry as j_registry
from repro.dist import sharding as j_sharding
from repro.launch import roofline as j_roofline
from repro.models import api as j_api
from repro.train import train_step as j_ts
from repro_torch import kernels as t_kernels
from repro_torch.configs import registry as t_registry
from repro_torch.kernels import easi_update, fake, flash_attention, fused_transform, ternary_matmul
from repro_torch.launch import dryrun, report, rescore, roofline
from repro_torch.models import api as t_api
from repro_torch.experiments import roofline_table
from torch_lm_parity import configs

CPU = torch.device("cpu")


def _ref_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {jax.tree_util.keystr(kp): tuple(spec) for kp, spec in flat}


# ---------------------------------------------------------------------------
# the shape cells
# ---------------------------------------------------------------------------

def test_shapes_equal_the_reference():
    assert set(t_api.SHAPES) == set(j_api.SHAPES)
    for name, cell in j_api.SHAPES.items():
        assert dataclasses.astuple(t_api.SHAPES[name]) == dataclasses.astuple(cell)


@pytest.mark.parametrize("shape", list(j_api.SHAPES))
@pytest.mark.parametrize("arch", j_registry.ARCH_IDS)
def test_cell_supported_and_input_specs_equal_the_reference(arch, shape):
    jc, tc = j_registry.get(arch), t_registry.get(arch)
    assert t_api.cell_supported(tc, shape) == j_api.cell_supported(jc, shape)
    if not j_api.cell_supported(jc, shape)[0]:
        return
    want = jax.eval_shape(lambda: j_api.input_specs(jc, shape))
    got = t_api.input_specs(tc, shape)
    want_flat = {jax.tree_util.keystr(kp): (tuple(v.shape), str(v.dtype))
                 for kp, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    got_flat = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], f"{path}[{k!r}]")
        else:
            assert fake.is_fake(tree), path
            got_flat[path] = (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))

    walk(got, "")
    assert got_flat == want_flat


# ---------------------------------------------------------------------------
# the ring model and the report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 16, 256])
@pytest.mark.parametrize("kind", roofline.COLLECTIVE_KINDS)
def test_wire_bytes_equal_the_reference(kind, n):
    for size in (0, 1, 4096, 3 * 2 ** 30):
        assert roofline._wire_bytes(kind, size, n) == j_roofline._wire_bytes(kind, size, n)


def _report_pair(t_comp, t_mem, t_coll, model_flops=4.0e15, chips=256, flops=2.0e13):
    common = dict(arch="a", shape="s", mesh="single", chips=chips, hlo_flops=flops,
                  hlo_bytes=1e12, collective_bytes=5e9, model_flops=model_flops, t_comp=t_comp,
                  t_mem=t_mem, t_coll=t_coll, sources={}, collectives={})
    return roofline.RooflineReport(**common), j_roofline.RooflineReport(**common)


@pytest.mark.parametrize("terms", [(1.0, 2.0, 0.5), (3.0, 2.0, 0.5), (0.1, 0.2, 0.9),
                                   (0.0, 0.0, 0.0)])
def test_report_properties_equal_the_reference(terms):
    got, want = _report_pair(*terms)
    assert got.dominant == want.dominant
    assert got.step_time_bound == want.step_time_bound
    assert got.flops_ratio == want.flops_ratio
    # the same formula, each package with its own chip's peak
    assert got.roofline_fraction * roofline.PEAK_FLOPS == pytest.approx(
        want.roofline_fraction * j_roofline.PEAK_FLOPS, rel=1e-12)
    assert set(got.to_json()) == set(want.to_json())
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]


def test_link_bandwidth_is_the_slowest_link_a_group_crosses():
    assert roofline.link_bw(range(8)) == roofline.NVLINK_BW
    assert roofline.link_bw([8, 9, 15]) == roofline.NVLINK_BW
    assert roofline.link_bw(range(16)) == roofline.IB_BW          # a `model` group of (16, 16)
    assert roofline.link_bw(range(0, 256, 16)) == roofline.IB_BW  # a `data` group
    c = roofline.Collective("all-reduce", 1e9, ("model",), tuple(range(16)))
    assert c.wire_bytes == j_roofline._wire_bytes("all-reduce", 1e9, 16)
    assert c.seconds == c.wire_bytes / roofline.IB_BW
    rep = roofline.analyze(arch="a", shape="s", mesh_name="single", chips=256, flops=989e12,
                           nbytes=3.35e12, collectives=[c], model_flops=1.0)
    assert (rep.t_comp, rep.t_mem, rep.t_coll) == (1.0, 1.0, c.seconds)
    assert roofline.format_table([rep]).splitlines()[2].startswith("a ")


def test_device_peak_flops():
    assert roofline.device_peak_flops("cuda") == (67e12, "datasheet")
    peak, source = roofline.device_peak_flops("cpu")
    assert source == "measured" and peak > 0
    assert roofline.device_peak_flops("cpu") == (peak, source)      # cached


# ---------------------------------------------------------------------------
# the dry run: fake against real, meshes, the fake process group
# ---------------------------------------------------------------------------

FAKE_REAL = [("h2o_danube3_4b", "train_4k"), ("h2o_danube3_4b", "prefill_32k"),
             ("h2o_danube3_4b", "decode_32k"), ("phi35_moe", "train_4k"),
             ("rwkv6_1b6", "train_4k"), ("zamba2_7b", "train_4k"), ("zamba2_7b", "decode_32k")]


@pytest.mark.parametrize("arch,shape", FAKE_REAL)
def test_fake_dry_run_equals_the_real_step(arch, shape):
    cfg = t_registry.get_smoke(arch)
    with dryrun.fake_world(1):
        mesh = dryrun.make_mesh("one", CPU)
        kw = dict(batch=2, seq=16, device=CPU)
        got = dryrun.build_and_count(cfg, shape, mesh, **kw)
        want = dryrun.build_and_count(cfg, shape, mesh, fake=False, **kw)
    g, w = got["count"], want["count"]
    assert g.flops == w.flops and g.flops > 0
    assert g.bytes == w.bytes and g.bytes > 0
    assert g.peak_bytes == w.peak_bytes and g.peak_bytes > 0
    assert g.peak_by_kind == w.peak_by_kind and sum(g.peak_by_kind.values()) == g.peak_bytes
    assert g.kernels == w.kernels == {"calls": {}, "flops": {}, "bytes": {}}
    assert got["state_bytes"] == want["state_bytes"]
    assert not dist.is_initialized()


def _ref_sharded_bytes(tree, specs, mesh):
    total = 0.0
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        denom = 1
        for ax in specs.get(jax.tree_util.keystr(kp), ()):
            if ax is not None:
                denom *= j_sharding.axis_size(mesh, ax)
        total += leaf.size * leaf.dtype.itemsize / denom
    return total


class StandInMesh:
    """What the reference's rules read of a mesh: axis names and a shape."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


@pytest.mark.parametrize("shape_id", ["2x4", "2x2x2"])
@pytest.mark.parametrize("arch", ["smollm_135m", "phi35_moe", "hubert_xlarge"])
def test_meshed_dry_run_state_bytes_equal_the_reference_arithmetic(arch, shape_id):
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = {"2x4": ((2, 4), ("data", "model")),
                    "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}[shape_id]
    jc, tc = configs(arch)
    jmesh = StandInMesh(shape, names)
    statuses = {}
    with dryrun.fake_world(math.prod(shape)):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        for cell in ("train_4k", "prefill_32k", "decode_32k"):
            ok, _ = t_api.cell_supported(tc, cell)
            statuses[cell] = ok
            if not ok:
                continue
            got = dryrun.build_and_count(tc, cell, mesh, batch=8, seq=16, device=CPU)
            if cell == "train_4k":
                jstate = jax.eval_shape(lambda: j_ts.init_state(
                    jax.random.PRNGKey(0), j_ts.TrainConfig(arch=jc)))
                want = _ref_sharded_bytes(jstate, _ref_specs(j_ts.state_specs(jstate, jmesh)),
                                          jmesh)
            else:
                jparams = jax.eval_shape(lambda: j_api.init_params(jax.random.PRNGKey(0), jc))
                want = _ref_sharded_bytes(jparams, _ref_specs(
                    j_sharding.param_specs(jparams, jmesh)), jmesh)
                if cell == "decode_32k":
                    jcache = jax.eval_shape(lambda: j_api.init_cache(jc, 8, 16))
                    want += _ref_sharded_bytes(jcache, _ref_specs(
                        j_sharding.cache_specs(jcache, jmesh)), jmesh)
            assert got["state_bytes"] == want, cell
            assert got["count"].peak_bytes >= got["state_bytes"]
    assert not dist.is_initialized()
    assert statuses == {c: j_api.cell_supported(jc, c)[0] for c in statuses}


def test_a_meshed_train_step_peaks_below_the_whole_params():
    """The step computes on shards: on a fake 8-rank (4 data, 2 model) world,
    smollm SMOKE at 32 layers (params 8× its activations) peaks per rank
    below the bytes of its whole params, which a step that gathered every
    param (and all-reduced whole gradients) would hold at least twice;
    every leaf splits 8 ways, so the rank stores params, m and v in under
    half of them."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = dataclasses.replace(t_registry.get_smoke("smollm_135m"), n_layers=32)
    whole = 4.0 * t_api.exact_param_counts(cfg)[0]           # f32 params
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
        got = dryrun.build_and_count(cfg, "train_4k", mesh, batch=8, seq=16, device=CPU)
    peak = got["count"].peak_bytes
    assert got["state_bytes"] < 0.5 * whole
    assert got["state_bytes"] < peak < whole, (got["state_bytes"], peak, whole)
    assert not dist.is_initialized()


def test_the_peak_lists_its_largest_storages():
    """`top`: the record lists the largest storages live at the peak, in
    descending bytes, each at least the bytes of the tensor that made it,
    together within the peak; and the peak is the one counted without it."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = t_registry.get_smoke("smollm_135m")
    counts = {}
    for top in (0, 5):
        with dryrun.fake_world(8):
            mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
            counts[top] = dryrun.build_and_count(cfg, "train_4k", mesh, top=top, batch=8,
                                                 seq=16, device=CPU)["count"]
    assert counts[0].peak_top == []
    listed = counts[5].peak_top
    assert len(listed) == 5 and counts[5].peak_bytes == counts[0].peak_bytes
    sizes = [e["bytes"] for e in listed]
    assert sizes == sorted(sizes, reverse=True) and sum(sizes) <= counts[5].peak_bytes
    for e in listed:
        assert isinstance(e["op"], str) and e["kind"]
        if e["op"] != "?":
            itemsize = torch.empty((), dtype=getattr(torch, e["dtype"].split(".")[-1])).element_size()
            assert e["bytes"] >= math.prod(e["shape"]) * itemsize, e
    assert not dist.is_initialized()


def test_a_split_step_counts_its_model_collectives():
    """On a fake (2 data, 4 model) world, h2o SMOKE split over `model`: the
    train step's counter records, over `model`, the stream's sequence
    gathers (two a layer, in the forward and again in the recompute) and
    their reduce-scatters, and the all-to-all moving `wo` / `w_out` to
    their row split; decode records gathers over `model` and no all-to-all
    (each product on the stored columns), and its per-rank FLOPs for 4
    rows are no more than a (8 data, 1 model) rank's for 1, which computes
    every product whole (without the split they would be 4×)."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = t_registry.get_smoke("h2o_danube3_4b")
    b, s = 8, 16
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        train = dryrun.build_and_count(cfg, "train_4k", mesh, batch=b, seq=s, device=CPU)
        dec = dryrun.build_and_count(cfg, "decode_32k", mesh, batch=b, seq=s, device=CPU)
        flat = init_device_mesh("cpu", (8, 1), mesh_dim_names=("data", "model"))
        dec_flat = dryrun.build_and_count(cfg, "decode_32k", flat, batch=b, seq=s, device=CPU)
    assert not dist.is_initialized()

    def over_model(count, kind):
        return [c for c in count.collectives if c.axes == ("model",) and c.kind == kind]

    stream = (b // 2) * s * cfg.d_model * 2                   # bf16 (B_local, S, d)
    gathers = [c for c in over_model(train["count"], "all-gather") if c.bytes == stream]
    scatters = [c for c in over_model(train["count"], "reduce-scatter") if c.bytes == stream]
    assert len(gathers) >= 4 * cfg.n_layers and len(scatters) >= 4 * cfg.n_layers
    assert over_model(train["count"], "all-to-all")
    assert over_model(dec["count"], "all-gather") and not over_model(dec["count"], "all-to-all")
    assert dec["count"].flops <= dec_flat["count"].flops


def test_a_cell_prices_rank_0_and_the_last_model_rank(monkeypatch):
    """`priced_ranks`: rank 0 and the last rank of `model`, every other
    coordinate 0.  Where attention splits its query rows over `model`
    (internvl2 SMOKE: 2 heads on 4 or 16 ranks) the last rank holds the
    last causal block and counts the most attention work of all, and a
    cell's record takes each term from the rank where it is larger."""
    from torch.distributed.device_mesh import init_device_mesh

    assert dryrun.priced_ranks("single") == (0, 15) and dryrun.priced_ranks("multi") == (0, 15)
    assert dryrun.priced_ranks("one") == (0,)
    cfg = t_registry.get_smoke("internvl2_1b")
    flash = {}
    for rank in range(4):
        with dryrun.fake_world(4, rank):
            assert dist.get_rank() == rank
            mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
            res = dryrun.build_and_count(cfg, "prefill_32k", mesh, batch=2, seq=64,
                                         device=dryrun.CARD)
        flash[rank] = res["count"].kernels["flops"]["flash_attention"]
    assert max(flash, key=flash.get) == 3 and flash[3] > flash[0], flash
    monkeypatch.setattr(dryrun.registry, "get", lambda arch_id: cfg)
    rec = dryrun.run_cell("internvl2_1b", "prefill_32k", "single", verbose=False, batch=16,
                          seq=56)
    assert set(rec["by_rank"]) == {"0", "15"} and rec["rank_of"]["flops"] == 15
    for term in ("t_comp", "t_mem", "t_coll"):
        assert rec[term] == pytest.approx(max(b[term] for b in rec["by_rank"].values()))
    assert rec["peak_bytes_per_device"] == max(b["peak_bytes"] for b in rec["by_rank"].values())
    assert not dist.is_initialized()


def test_run_cell_statuses_follow_cell_supported(monkeypatch, tmp_path):
    cfg = t_registry.get_smoke("hubert_xlarge")
    monkeypatch.setattr(dryrun.registry, "get", lambda arch_id: cfg)
    skipped = dryrun.run_cell("hubert_xlarge", "decode_32k", "single", verbose=False)
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == t_api.cell_supported(cfg, "decode_32k")[1]
    rec = dryrun.run_cell("hubert_xlarge", "prefill_32k", "single", verbose=False, batch=32,
                          seq=16)
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["mesh"] == "single"
    assert rec["fits"] == (rec["peak_bytes_per_device"] <= 80e9)
    assert {c["kind"] for c in rec["collective_calls"]} <= set(roofline.COLLECTIVE_KINDS) | {
        "broadcast"}
    assert all(len(c["ranks"]) in (16,) for c in rec["collective_calls"])
    assert not dist.is_initialized()


def test_the_cli_writes_a_cell_and_skips_it_after(monkeypatch, tmp_path, capsys):
    cfg = t_registry.get_smoke("smollm_135m")
    monkeypatch.setattr(dryrun.registry, "get", lambda arch_id: cfg)
    real = dryrun.build_cell
    monkeypatch.setattr(dryrun, "build_cell",
                        lambda *a, **kw: real(*a, **{**kw, "batch": 16, "seq": 16}))
    argv = ["--arch", "smollm_135m", "--shape", "decode_32k", "--mesh", "single",
            "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    path = tmp_path / "smollm_135m__decode_32k__single.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["arch"] == "smollm_135m" and rec["batch"] == 16
    assert dryrun.main(argv) == 0
    assert "skip existing" in capsys.readouterr().out
    assert not dist.is_initialized()


def test_the_fake_group_never_leaks():
    assert not dist.is_initialized()
    with pytest.raises(ZeroDivisionError):
        with dryrun.fake_world(4):
            assert dist.get_world_size() == 4
            1 / 0
    assert not dist.is_initialized()
    # a real group may start and run after a dry run in the same process
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        t = torch.ones(3)
        dist.all_reduce(t)
        assert torch.equal(t, torch.ones(3))
        with pytest.raises(RuntimeError, match="already up"):
            with dryrun.fake_world(4):
                pass
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the kernels' fake branch
# ---------------------------------------------------------------------------

def _calls(dev, gen=None):
    """One call of each wrapper on tensors of `dev` (under a fake mode when
    the caller made one)."""
    g = torch.Generator().manual_seed(3)

    def t(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype).to(dev)

    r = torch.randint(-1, 2, (24, 40), generator=g).to(torch.int8).to(dev)
    return {
        "ternary_matmul": lambda: ternary_matmul.ternary_matmul(t(5, 40), r, scale=0.3),
        "fused_transform": lambda: fused_transform.fused_transform(t(5, 40), r, t(8, 24),
                                                                   scale=0.3),
        "easi_apply": lambda: easi_update.easi_apply(t(8, 24), t(16, 8), mu=1e-3),
        "flash_attention": lambda: flash_attention.flash_attention(
            t(1, 9, 4, 16, dtype=torch.bfloat16), t(1, 9, 2, 16, dtype=torch.bfloat16),
            t(1, 9, 2, 16, dtype=torch.bfloat16), return_lse=True),
    }


def test_a_real_cpu_tensor_never_takes_the_fake_branch(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the fake branch ran on a real tensor")

    monkeypatch.setattr(fake, "report", refuse)
    before = t_kernels.launch_counts()
    for name, call in _calls(CPU).items():
        out = call()
        out = out[0] if isinstance(out, tuple) else out
        assert not fake.is_fake(out), name
    assert t_kernels.launch_counts() == before


@pytest.mark.parametrize("device", ["cuda:0", "meta"])
def test_a_fake_tensor_counts_no_launch_and_reports_its_work(device):
    from torch._subclasses.fake_tensor import FakeTensorMode

    before = t_kernels.launch_counts()
    want = {"ternary_matmul": ((5, 24), torch.float32), "fused_transform": ((5, 8), torch.float32),
            "easi_apply": ((8, 24), torch.float32), "flash_attention": ((1, 9, 4, 16),
                                                                        torch.bfloat16)}
    with FakeTensorMode(allow_non_fake_inputs=True), fake.recording() as work:
        for name, call in _calls(torch.device(device)).items():
            out = call()
            if name == "flash_attention":
                out, lse = out
                assert tuple(lse.shape) == (1, 4, 9) and lse.dtype == torch.float32
            assert fake.is_fake(out) and out.device == torch.device(device), name
            assert (tuple(out.shape), out.dtype) == want[name]
    assert t_kernels.launch_counts() == before
    assert work.calls == dict.fromkeys(want, 1)
    assert work.flops["ternary_matmul"] == 2.0 * 5 * 40 * 24
    assert work.flops["fused_transform"] == 2.0 * 5 * 40 * 24 + 2.0 * 5 * 24 * 8
    assert work.flops["easi_apply"] == 2.0 * 16 * 8 * 8 * 2 + 2.0 * 8 * 8 * 24
    assert work.flops["flash_attention"] == 4.0 * 4 * 16 * (9 * 10 // 2)   # causal pairs
    assert work.bytes["ternary_matmul"] == 5 * 40 * 4 + 24 * 40 + 5 * 24 * 4


def test_the_fake_flash_allocates_no_scores():
    """At a 32k prefill the plain version's S × S scores would take 4 GiB a
    head; the fake branch allocates the output and lse only."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    s, h, dh = 32768, 2, 64
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = torch.empty((1, s, h, dh), dtype=torch.bfloat16, device="meta")
        mt = MemTracker()
        mt.track_external(q)
        with mt:
            out, lse = flash_attention.flash_attention(q, q, q, return_lse=True)
        peak = sum(v["Total"] for v in mt.get_tracker_snapshot("peak").values())
    assert peak <= 2 * q.numel() * 2 + lse.numel() * 4 + 4096
    assert fake.visible_pairs(s, s, True, None, 0) == s * (s + 1) // 2
    assert fake.visible_pairs(8, 8, True, 3, 0) == 1 + 2 + 3 * 6
    assert fake.visible_pairs(1, 100, True, 16, 99) == 16
    assert fake.visible_pairs(4, 6, False, None, 0) == 24


# ---------------------------------------------------------------------------
# report, rescore, the roofline table
# ---------------------------------------------------------------------------

KNOWN = {"arch": "yi_6b", "shape": "train_4k", "mesh": "single", "status": "ok", "chips": 256,
         "build_s": 12.5, "state_bytes_per_device": 2.5e9, "peak_bytes_per_device": 9.0e10,
         "hlo_flops": 1.0e15, "hlo_bytes": 2.0e13, "model_flops": 1.0e17,
         "collective_calls": [{"kind": "all-reduce", "bytes": 1e9, "axes": ["data"],
                               "ranks": list(range(0, 256, 16))},
                              {"kind": "all-gather", "bytes": 2e9, "axes": ["model"],
                               "ranks": list(range(16))}],
         "memory_per_device": 9.0e10}


def _write_known(tmp_path, **changes):
    rec = dict(KNOWN, **changes)
    rep = roofline.analyze(arch=rec["arch"], shape=rec["shape"], mesh_name=rec["mesh"],
                           chips=rec["chips"], flops=1.0, nbytes=1.0, collectives=[],
                           model_flops=rec["model_flops"])     # stale terms, to be re-scored
    rec.update({k: v for k, v in rep.to_json().items()
                if k not in ("hlo_flops", "hlo_bytes", "memory_per_device")})
    path = tmp_path / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    path.write_text(json.dumps(rec))
    return path


def test_rescore_is_idempotent(tmp_path):
    path = _write_known(tmp_path)
    (tmp_path / "x__decode_32k__single.json").write_text(json.dumps(
        {"arch": "x", "shape": "decode_32k", "mesh": "single", "status": "skipped",
         "reason": "r"}))
    assert rescore.main(["--dir", str(tmp_path)]) == 0
    once = json.loads(path.read_text())
    want = 1.0e15 / roofline.PEAK_FLOPS
    assert once["t_comp"] == want and once["t_mem"] == 2.0e13 / roofline.HBM_BW
    assert once["t_coll"] == (2 * 1e9 * 15 / 16 + 2e9 * 15 / 16) / roofline.IB_BW
    assert once["dominant"] == "memory"
    assert rescore.main(["--dir", str(tmp_path)]) == 0
    assert json.loads(path.read_text()) == once


def test_report_formats_a_known_json(tmp_path, capsys):
    path = _write_known(tmp_path)
    rescore.rescore_file(str(path))
    (tmp_path / "x__decode_32k__single.json").write_text(json.dumps(
        {"arch": "x", "shape": "decode_32k", "mesh": "single", "status": "skipped",
         "reason": "encoder-only arch has no decode step"}))
    assert report.main(["--dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "(1 ok / 1 skipped / 0 error;" in out
    assert "| yi_6b | train_4k | single | ok | 12.5 | 2.50 | 90.00 | 1.12 (over) |" in out
    assert "| x | decode_32k | single | skipped: encoder-only arch has no decode step" in out
    assert "| yi_6b | train_4k | 1.0111 | 5.9701 | 0.0750 | 5.9701 | memory | 0.391 | 6.6 |" \
        in out
    assert "| yi_6b | train_4k | 1.875 | 1.875 | 0.000 | 0.000 | 0.000 |" in out
    rows = roofline_table.run(dir_=str(tmp_path))
    assert [r[0] for r in rows] == ["roofline/yi_6b/train_4k"]
    assert rows[0][1] == pytest.approx(5.9701492537e6)
    assert "peakGB=90.00" in rows[0][2]


def test_wire_bytes_by_axis_and_by_kind():
    """`report.wire_by_axis`: the ring model's wire bytes a rank, summed by
    the axes of each collective's group, or by kind and axes."""
    assert report.wire_by_axis(KNOWN) == pytest.approx({"data": 1.875e9, "model": 1.875e9})
    assert report.wire_by_axis(KNOWN, by_kind=True) == pytest.approx(
        {"all-reduce over data": 1.875e9, "all-gather over model": 1.875e9})


def test_report_compares_two_sweeps_with_wire_bytes_by_axis(tmp_path, capsys):
    """`report --before`: each cell ok in both sweeps, peak, the roofline
    terms and the ring model's wire bytes a rank by mesh axis (an all-reduce
    of 1 GB over 16 ranks moves 1.875 GB, an all-gather of 2 GB 1.875)."""
    before, after = tmp_path / "before", tmp_path / "after"
    before.mkdir()
    after.mkdir()
    rescore.rescore_file(str(_write_known(before)))
    rescore.rescore_file(str(_write_known(after, memory_per_device=4.5e10,
                                          peak_bytes_per_device=4.5e10,
                                          collective_calls=KNOWN["collective_calls"][1:])))
    assert report.main(["--dir", str(after), "--before", str(before)]) == 0
    out = capsys.readouterr().out
    assert "| yi_6b | train_4k | 90.00 → 45.00 |" in out
    assert "| 1.88 / 1.88 → 0.00 / 1.88 |" in out
