"""The resource model of the port's CUDA kernels (`kernels/resource_model.py`).

Coverage is held both ways against the `.cu` sources: every `__global__`
has an estimator and every estimator a body, with the source's
`__launch_bounds__`.  Every body choice that `chip_smoke.py`'s shapes and
the serving engine's buckets (8 … 1024) reach, at every tile template, is
inside the H100's limits.  The model's shared bytes, register ceilings and
CTAs an SM are pinned to what `cudaFuncGetAttributes` and
`cudaOccupancyMaxActiveBlocksPerMultiprocessor` read on an H100 80GB HBM3
(700 W) in chip_smoke.py's `[resources]` phase, where they agree; that
phase holds every instance against the card on every run."""

import importlib.util
import json
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import autotune
from repro_torch.kernels import resource_model as rm
from repro_torch.serve import BucketPolicy

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\(([^)]*)\)\s+)?(\w+)\s*\(")


def _bodies():
    """{kernel name: (source file, __launch_bounds__ arguments)} from csrc/."""
    out = {}
    for path in sorted(CSRC.glob("*.cu*")):
        for bounds, name in GLOBAL.findall(path.read_text()):
            out[name] = (path.name, [a.strip() for a in bounds.split(",")] if bounds else [])
    return out


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_kernel_body_has_an_estimator_and_every_estimator_a_body():
    bodies = _bodies()
    assert len(bodies) == 12
    assert set(bodies) == set(rm.MODELED_KERNELS)


def test_the_estimators_follow_each_body_s_source_and_launch_bounds():
    bodies = _bodies()
    for est in rm.every_instance():
        source, bounds = bodies[est.kernel]
        assert est.source == source, est.kernel
        assert est.min_ctas == (int(bounds[1]) if len(bounds) > 1 else 1), est.kernel
        assert est.threads == 256, est.kernel            # NTHREADS, FT_THREADS, TC_THREADS, ...
    assert {e.kernel for e in rm.every_instance()} == set(rm.MODELED_KERNELS)
    assert len(rm.every_instance()) == 124      # 122 + the bf16 forward at D 224, both load paths


# (kernel, variant) -> (static, dynamic, CTAs an SM) read on an NVIDIA H100 80GB HBM3 at
# 700 W by `chip_smoke.py --only resources`
CARD = {("ternary_matmul_dense_kernel", "f32"): (8448, 0, 8),
        ("ternary_matmul_sparse_kernel", "f32,RL=1,PT=64"): (0, 44288, 2),
        ("ternary_matmul_sparse_kernel", "f32,RL=2,PT=16"): (0, 72768, 2),
        ("fused_transform_dense_kernel", "f32/f32"): (20992, 0, 5),
        ("fused_transform_kernel", "f32/f32,RL=1,PT=64"): (0, 61184, 2),
        ("fused_transform_kernel", "bf16/bf16,RL=2,PT=64"): (0, 102144, 2),
        ("fused_transform_sum_kernel", "f32"): (0, 0, 4),
        ("easi_small_kernel", "f32/f32,NA=4,CT=32"): (33024, 8448, 2),
        ("easi_small_kernel", "f32/f32,NA=4,CT=64"): (33024, 16640, 2),
        ("easi_small_kernel", "bf16/bf16,NA=4,CT=128"): (33024, 33024, 1),
        ("easi_gram_kernel", "f32"): (20896, 0, 5),
        ("easi_update_kernel", "bf16,UC=16"): (29568, 8704, 4),
        ("easi_update_kernel", "f32,UC=32"): (33664, 16896, 1),
        ("easi_update_kernel", "bf16,UC=64"): (41856, 33280, 2),
        ("flash_attention_kernel", "f32,DH=128"): (0, 115456, 2),
        ("flash_tc_kernel", "bf16,D=128,VEC=1"): (0, 69632, 1),
        ("flash_tc_kernel", "bf16,D=224,VEC=1"): (0, 178176, 1),
        ("flash_bwd_dq_kernel", "bf16,D=16"): (0, 12288, 2),
        ("flash_bwd_dq_kernel", "bf16,D=80"): (0, 45056, 1),
        ("flash_bwd_dkdv_kernel", "bf16,D=80"): (0, 91136, 1),
        ("flash_bwd_dkdv_kernel", "bf16,D=128"): (0, 140288, 1)}


def test_the_model_agrees_with_the_card_s_readings():
    by = {(e.kernel, e.variant): e for e in rm.every_instance()}
    for key, (static, dynamic, ctas) in CARD.items():
        est = by[key]
        assert (est.static_smem, est.dynamic_smem) == (static, dynamic), key
        assert est.ctas_per_sm <= ctas, key      # the model counts threads at the ceiling


def test_every_instance_is_inside_the_h100_limits():
    for est in rm.every_instance():
        assert est.validate() == [], est
    assert rm.paper_scale_report() and all(not e.validate() for e in rm.paper_scale_report())


def test_validate_names_each_broken_limit():
    est = rm.fused_transform_sparse_estimate(256, 1024, 256, 128, block_m=64, block_p=64)
    import dataclasses

    assert any("static shared" in p for p in dataclasses.replace(
        est, static_smem=50_000).validate())
    assert any("a CTA >" in p for p in dataclasses.replace(
        est, dynamic_smem=rm.SMEM_PER_CTA + 1).validate())
    assert any("__launch_bounds__ asks 2" in p for p in dataclasses.replace(
        est, dynamic_smem=120_000).validate())
    assert any("cluster of 16" in p for p in dataclasses.replace(est, cluster=16).validate())
    assert any("threads a CTA" in p for p in dataclasses.replace(est, threads=2048).validate())


def _every_tile(call, *shape, **kw):
    out = []
    for bm in (32, 64, 128):
        for bp in (16, 32, 64, 128):
            out += call(*shape, block_m=bm, block_p=bp, **kw)
    return out


def test_chip_smoke_shapes_stay_inside_the_limits():
    cs = _chip_smoke()
    ests = []
    for b, m, p in cs.TMM_SHAPES + [(cs.WIDE["block"], cs.WIDE["m"], cs.WIDE["p"])]:
        for bf16 in (False, True):
            ests += _every_tile(rm.ternary_matmul_call, b, m, p, bf16=bf16)
    for b, m, p, *_ in cs.TMM_EDGE:
        ests += _every_tile(rm.ternary_matmul_call, b, m, p)
    for rows, m, p, n in cs.FUSED_SHAPES:
        ests += _every_tile(rm.fused_transform_call, rows, m, p, n)
    for rows, m, p, n, *_ in cs.FUSED_EDGE:
        for bf16 in (False, True):
            ests += _every_tile(rm.fused_transform_call, rows, m, p, n, bf16=bf16)
    for b, n, m in cs.EASI_SHAPES:
        ests += rm.easi_apply_call(b, n, m)
    for b, n, m, *_ in cs.EASI_EDGE:
        ests += rm.easi_apply_call(b, n, m)
    for b, sq, skv, hq, hkv, dh, *_ in cs.FLASH_SHAPES:
        for bf16 in (False, True):
            ests += rm.flash_attention_call(b, sq, skv, hq, hkv, dh, bf16=bf16)
    for b, sq, skv, hq, hkv, dh, *_ in cs.FLASH_SHAPES + cs.FLASH_GRAD_SHAPES:
        ests += rm.flash_attention_bwd_call(b, sq, skv, hq, hkv, dh)
    assert {e.kernel for e in ests} == set(rm.MODELED_KERNELS)
    for est in ests:
        assert est.validate() == [], est


@pytest.mark.parametrize("model", ["paper", "wide"])
def test_every_bucket_candidate_stays_inside_the_limits(model):
    cs = _chip_smoke()
    dims = cs.PAPER if model == "paper" else cs.WIDE
    m, p, n = dims["m"], dims["p"], dims["n"]
    for bucket in BucketPolicy(**cs.SERVE_BUCKETS).buckets():
        cands = autotune.candidates(bucket, p, m, first=autotune.TileConfig())
        assert 1 <= len(cands) <= 6
        if model == "paper":
            assert len(cands) == 1
        for c in cands:
            for est in (rm.fused_transform_call(bucket, m, p, n, block_m=c.block_m,
                                                block_p=c.block_p)
                        + rm.ternary_matmul_call(bucket, m, p, block_m=c.block_m,
                                                 block_p=c.block_p)
                        + rm.easi_apply_call(bucket, n, p)):
                assert est.validate() == [], (bucket, c, est)


def test_effective_tiles_clamp_to_the_templates_and_the_problem():
    assert rm.effective_tiles(1024, 16, 32) == rm.DENSE_TILES          # paper scale: dense
    # Execution's defaults (128, 128) name no template: the default tiling
    assert rm.effective_tiles(1024, 256, 1024) == rm.DEFAULT_TILE == (32, 64)
    assert rm.effective_tiles(1024, 256, 1024, 8, 8) == (32, 64)
    assert rm.effective_tiles(1024, 256, 1024, 64, 16) == (64, 16)      # a template: as named
    assert rm.effective_tiles(16, 256, 1024, 64, 64) == (32, 64)        # 16 rows: a 32-row tile
    assert rm.effective_tiles(1024, 20, 4000, 64, 64) == (64, 32)       # p = 20: PT 32 holds it
    for rows, p, m in ((8, 256, 1024), (1024, 200, 600), (300, 70, 2100)):
        effs = {rm.effective_tiles(rows, p, m, bm, bp)
                for bm in (1, 32, 64, 128, 512) for bp in (1, 16, 32, 64, 128)}
        assert len(effs) <= 6
        for e in effs:
            assert rm.effective_tiles(rows, p, m, *e) == e                # idempotent


def test_the_sources_compile_the_model_s_tile_templates():
    # ternary_encode.cuh's ft_with_tile is the C++ list of templates both
    # .cu entries dispatch on; it must be the model's TILE_ROWS x TILE_P
    text = (CSRC / "ternary_encode.cuh").read_text()
    cases = re.findall(r"case (\d+): return f\(FtTile<(\d+), (\d+)>\{\}\);", text)
    assert {(32 * int(rl), int(pt)) for _, rl, pt in cases} == {
        (bm, bp) for bm in rm.TILE_ROWS for bp in rm.TILE_P}
    assert all(int(k) == 32 * int(rl) * 100 + int(pt) for k, rl, pt in cases)


def test_p_tiles_mirror_the_card():
    # repro_fused_transform_tiles on an H100 (132 SMs), as chip_smoke.py's [serve] printed
    # them at the wide row
    assert rm.ft_p_tiles(8, 256, 132, 32, 32) == 32
    assert rm.ft_p_tiles(1024, 256, 132, 32, 64) == 16
    assert rm.ft_p_tiles(8500, 60, 132, 64, 32) == 1                   # row tiles fill the card


def test_the_cli_writes_its_rows(tmp_path, capsys):
    out = tmp_path / "rows.json"
    assert rm.main(["--json", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert len(rows) == len(rm.paper_scale_report())
    assert {r["name"].split("<")[0].split("/")[1] for r in rows} == set(rm.MODELED_KERNELS)
    for r in rows:
        assert set(r) == {"name", "source", "threads", "grid", "static_smem", "dynamic_smem",
                          "reg_ceiling", "cluster", "ctas_per_sm"}
    assert "fused_transform_kernel<f32,RL=2,PT=64>" in capsys.readouterr().out
