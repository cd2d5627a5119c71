"""The port's tile race (`kernels/autotune.py`) and the serving engine's
`autotunes` count, mirroring the reference's `tests/test_fused_transform.py`
(`TestAutotune`, `TestServiceAutotuneCache`): candidates deduped by their
effective tiles with the model's own first, ties kept by the first under
a zero-elapsed virtual clock, no timing for a single candidate, and one
race per bucket at register, none at a promote, another after an eviction.
On the CPU the programs are the plain versions; the race's candidates are
the sparse bodies' tile templates, so a problem whose R takes the sparse
body (p · m ≥ 65 536) races up to six of them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import dr as tdr
from repro_torch.kernels import autotune
from repro_torch.kernels import resource_model as rm
from repro_torch.serve import BucketPolicy, DRService, VirtualClock


class TestAutotune:
    def test_paper_scale_sweep_collapses_to_one(self):
        # m = 32, p = 16, bucket 64: R takes the dense body, whose one tiling
        # every candidate clamps to
        assert len(autotune.candidates(64, 16, 32)) == 1

    def test_first_candidate_leads_and_dedupes(self):
        mine = autotune.TileConfig(64, 128, 128)
        cands = autotune.candidates(1024, 200, 600, first=mine)
        assert cands[0] == mine
        assert len(cands) == len(set(c.effective(1024, 200, 600) for c in cands))
        assert 1 < len(cands) <= 6
        assert {c.effective(1024, 200, 600) for c in cands} == {
            autotune.TileConfig(bm, bp, rm.WORD) for bm in rm.TILE_ROWS for bp in rm.TILE_P}

    def test_small_buckets_race_the_32_row_tiles_only(self):
        cands = autotune.candidates(16, 256, 1024, first=autotune.TileConfig())
        assert {c.effective(16, 256, 1024).block_m for c in cands} == {32}
        assert len(cands) == 3

    def test_tie_keeps_first_candidate(self):
        built = []

        def build(tiles):
            built.append(tiles)
            return lambda v: v + 1.0

        cands = (autotune.TileConfig(32, 64, 32), autotune.TileConfig(64, 16, 32))
        prog = autotune.tune(cands, build, (torch.zeros(4),),
                             timer=lambda: 0.0)  # virtual clock: all tie
        assert prog.tiles == cands[0]
        assert built == list(cands)
        assert set(prog.timings_ms) == set(cands)
        assert prog.device == "cpu"

    def test_the_fastest_candidate_wins(self):
        now = [0.0]
        cost = {32: 3.0, 64: 1.0}

        def build(tiles):
            def fn(v):
                now[0] += cost[tiles.block_m]
                return v
            return fn

        cands = (autotune.TileConfig(32, 64, 32), autotune.TileConfig(64, 64, 32))
        prog = autotune.tune(cands, build, (torch.zeros(2),), timer=lambda: now[0], reps=3)
        assert prog.tiles == cands[1]
        assert prog.timings_ms == {cands[0]: 3.0, cands[1]: 1.0}

    def test_a_near_tie_keeps_the_leader(self):
        # a challenger within RACE_MARGIN of the leader, or whose samples
        # overlap the leader's, does not take the lead
        now, calls = [0.0], {}
        costs = {16: [1.0, 1.0, 1.0], 32: [0.9375] * 3, 64: [0.5, 1.25, 0.5]}

        def build(tiles):
            def fn(v):
                k = calls.get(tiles.block_p, 0)
                calls[tiles.block_p] = k + 1
                now[0] += costs[tiles.block_p][(k - 1) % 3] if k else 0.0
                return v
            return fn

        cands = tuple(autotune.TileConfig(32, bp, 32) for bp in (16, 32, 64))
        prog = autotune.tune(cands, build, (torch.zeros(2),), timer=lambda: now[0], reps=3)
        assert prog.tiles == cands[0]
        assert prog.timings_ms == {cands[0]: 1.0, cands[1]: 0.9375, cands[2]: 0.5}

    def test_single_candidate_skips_timing(self):
        built = []

        def build(tiles):
            built.append(tiles)
            return lambda v: v

        prog = autotune.tune((autotune.TileConfig(),), build, (torch.zeros(2),),
                             timer=lambda: 0.0)
        assert built == [autotune.TileConfig()]
        assert prog.timings_ms == {}

    def test_a_race_needs_a_timer(self):
        with pytest.raises(ValueError, match="timer"):
            autotune.tune((autotune.TileConfig(), autotune.TileConfig(32, 16, 32)),
                          lambda t: (lambda v: v), (torch.zeros(2),), timer=None)
        with pytest.raises(ValueError, match="at least one"):
            autotune.tune((), lambda t: (lambda v: v), (torch.zeros(2),), timer=None)


def _model(m=1024, p=64, n=8, backend="kernel"):
    """R of 64 × 1024: the sparse body, so buckets past 32 rows race six."""
    return tdr.DRModel(stages=(tdr.RPStage(m, p), tdr.EASIStage.rotation(p, n, mu=1e-3)),
                       execution=tdr.Execution(backend=backend, device="cpu"), block_size=4)


class TestServiceAutotuneCache:
    def _svc(self, cache_size=32, max_bucket=8, model=None):
        model = model if model is not None else _model()
        svc = DRService(buckets=BucketPolicy(min_bucket=4, max_bucket=max_bucket),
                        compile_cache_size=cache_size, clock=VirtualClock())
        state = model.init(torch.Generator().manual_seed(0))
        svc.register("m", model, state)
        return svc, model, state

    def test_register_tunes_every_bucket(self):
        svc, model, state = self._svc(max_bucket=64)       # buckets 4 … 64
        n = len(svc.buckets.buckets())
        assert svc.metrics()["autotunes"] == n
        assert svc.cache.misses == n
        snap = svc.registry.get("m")
        prog = svc._transform_fn(snap, 64, torch.float32)
        assert isinstance(prog, autotune.TunedProgram)
        # a tied race (virtual clock) keeps the policy's own tiles
        exe = model.execution
        assert prog.tiles == autotune.TileConfig(exe.tmm_block_m, exe.tmm_block_p,
                                                 exe.tmm_block_k)
        assert len(prog.timings_ms) == 6 and set(prog.timings_ms.values()) == {0.0}
        assert svc.metrics()["autotunes"] == n              # that was a cache hit
        x = torch.from_numpy(np.random.default_rng(0).standard_normal((40, 1024))
                             .astype(np.float32))
        torch.testing.assert_close(svc.transform("m", x), model.transform(state, x),
                                   rtol=0, atol=0)

    def test_promote_never_retunes(self):
        svc, model, state = self._svc()                    # buckets 4, 8
        assert svc.metrics()["autotunes"] == 2
        gen = torch.Generator().manual_seed(1)
        for _ in range(3):
            svc.serve_and_update("m", torch.randn((4, 1024), generator=gen))
        m0 = svc.cache.misses          # transform buckets + the tws program
        svc.promote("m")                                   # same chash → cache hit
        svc.transform("m", torch.ones((8, 1024)))
        assert svc.metrics()["autotunes"] == 2
        assert svc.cache.misses == m0

    def test_eviction_drops_program_and_tiles_then_retunes(self):
        svc, model, state = self._svc(cache_size=1)        # buckets 4, 8
        assert svc.metrics()["autotunes"] == 2             # bucket-4 entry evicted
        assert len(svc.cache) == 1
        svc.transform("m", torch.ones((4, 1024)))          # rebuild → re-tune
        assert svc.metrics()["autotunes"] == 3
        assert svc.cache.misses == 3

    def test_torch_backend_register_does_not_tune(self):
        svc, _, _ = self._svc(model=_model(backend="torch"))
        assert svc.metrics()["autotunes"] == 0
        assert svc.cache.misses == 0                       # built lazily, as XLA compiles
