"""The port's serving engine (`repro_torch.serve`) against the JAX package's
on the CPU: bucket policy, bounded compile cache, registry, micro-batched
serving, train-while-serve, the autotuner's contract, content addressing,
the deadline scheduler and its SLO accounting.

The DR parts of `tests/test_serve_engine.py` and `tests/test_scheduler.py`
are mirrored on the reference's small model (32 → 16 → 8, block 4).  Side
by side, a JAX `DRService` (XLA backend) and the port's (kernel backend; on
the CPU its wrappers run their plain versions) serve the same state,
imported through `repro_torch.bridge`, and the same ragged stream.  All
time is virtual: nothing here sleeps.  On the card each bucket program is
a captured CUDA graph; `chip_smoke.py` drives that path.  The LM steps
through the queue are held in `tests/test_torch_lm_zoo.py` (the
reference's own test of them fails); here only their mesh refusal."""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.serve as jserve
from harness import ServingHarness as JaxHarness
from harness import small_model as jax_small_model
from repro.serve import durability as jdurability
from repro_torch import bridge
from repro_torch import dr as tdr
from repro_torch.dist import compress
from repro_torch.kernels import autotune
from repro_torch.serve import (BoundedCompileCache, BucketPolicy, DeadlineScheduler, DRService,
                               ModelRegistry, MonotonicClock, QueueFull, SchedulerClosed,
                               VirtualClock)
from repro_torch.serve import durability, registry as tregistry
from repro_torch.serve.batching import EXACT, MicroBatcher
from repro_torch.serve.slo import LatencyStats, SLOTracker

REPO = Path(__file__).resolve().parent.parent
SAME = dict(rtol=1e-5, atol=1e-6)          # the port against the reference, f32
TRAJ = dict(rtol=5e-4, atol=5e-5)          # trajectory bound, tests/test_kernels.py:162
EXACT_TOL = dict(rtol=0, atol=0)
TIGHT = dict(rtol=1e-6, atol=1e-7)         # tests/test_scheduler.py, a padded bucket against
                                           # the unpadded request
BUCKETS = dict(min_bucket=4, max_bucket=32)
SIZES = [3, 7, 1, 5, 12, 2, 9, 30, 4]      # buckets 4, 8, 16, 32


def _tmodel(m=32, p=16, n=8, block=4, backend="kernel", device="cpu"):
    return tdr.DRModel(stages=(tdr.RPStage(m, p), tdr.EASIStage.rotation(p, n, mu=1e-3)),
                       execution=tdr.Execution(backend=backend, device=device),
                       block_size=block)


def _states(seed=0, m=32):
    """(reference state, the same state in the port) for the small model."""
    js = jax_small_model(m=m).init(jax.random.PRNGKey(seed))
    return js, bridge.from_reference(js, device="cpu")


def _np(rows, seed=0, m=32):
    return np.random.default_rng(seed).standard_normal((rows, m)).astype(np.float32)


def _x(rows, seed=0, m=32):
    return torch.from_numpy(_np(rows, seed, m))


def _service(model=None, seed=0, **kw):
    kw.setdefault("buckets", BucketPolicy(**BUCKETS))
    model = model if model is not None else _tmodel()
    svc = DRService(**kw)
    _, st = _states(seed, m=model.in_dim)
    svc.register("m", model, st)
    return svc, model, st


def _pair(seed=0, **kw):
    """A JAX service (XLA backend) and the port's, each holding `seed`'s
    state as "m"."""
    kw.setdefault("buckets", BUCKETS)
    js, ts = _states(seed)
    jsvc = jserve.DRService(buckets=jserve.BucketPolicy(**kw["buckets"]))
    tsvc = DRService(buckets=BucketPolicy(**kw["buckets"]))
    jm, tm = jax_small_model(), _tmodel()
    jsvc.register("m", jm, js)
    tsvc.register("m", tm, ts)
    return (jsvc, jm, js), (tsvc, tm, ts)


def _close(got, want, tol=SAME):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _assert_states(t_state, j_state, tol):
    stages, steps, trainable = bridge.to_numpy(t_state)
    assert int(steps) == int(j_state.steps)
    assert trainable == j_state.trainable
    for got, want in zip(stages, j_state.stages):
        np.testing.assert_allclose(got, np.asarray(want), **tol)


class PortHarness:
    """`tests/harness.py::ServingHarness` over the port: VirtualClock +
    DRService + DeadlineScheduler, advanced by hand, never sleeping."""

    def __init__(self, *, name="m", seed=0, buckets=None, default_max_delay_ms=10.0,
                 flush_rows=None, wake_lead_ms=0.0, threaded=False, **service_kw):
        self.clock = VirtualClock()
        self.model = _tmodel()
        self.name = name
        self.service = DRService(buckets=buckets if buckets is not None
                                 else BucketPolicy(**BUCKETS), clock=self.clock, **service_kw)
        self.state = _states(seed)[1]
        self.service.register(name, self.model, self.state)
        self.threaded = threaded
        self.scheduler = DeadlineScheduler(
            self.service, default_max_delay_ms=default_max_delay_ms, flush_rows=flush_rows,
            wake_lead_ms=wake_lead_ms, start=threaded)

    def submit(self, x, *, name=None, max_delay_ms=None):
        return self.scheduler.submit(name if name is not None else self.name, x,
                                     max_delay_ms=max_delay_ms)

    def submit_step(self, tag, kind, fn, *args, rows=1, max_delay_ms=None):
        return self.scheduler.submit_step(tag, kind, fn, *args, rows=rows,
                                          max_delay_ms=max_delay_ms)

    def advance(self, ms):
        self.clock.advance(ms)
        return 0 if self.threaded else self.scheduler.poll()

    def poll(self):
        return self.scheduler.poll()

    def now(self):
        return self.clock.now()

    def expect(self, x):
        return self.model.transform(self.state, x)

    def shutdown(self, **kw):
        self.scheduler.shutdown(**kw)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


# ---------------------------------------------------------------------------
# engine: bucket policy, cache, registry
# ---------------------------------------------------------------------------

class TestBucketPolicy:
    @pytest.mark.parametrize("lo,hi", [(4, 64), (8, 1024), (1, 1), (3, 40)])
    def test_buckets_match_reference(self, lo, hi):
        p, jp = BucketPolicy(min_bucket=lo, max_bucket=hi), jserve.BucketPolicy(lo, hi)
        assert p.buckets() == jp.buckets()
        assert [p.bucket_for(n) for n in range(1, 2 * hi + 2)] == \
            [jp.bucket_for(n) for n in range(1, 2 * hi + 2)]

    def test_pow2_padding_and_exact_policy(self):
        p = BucketPolicy(min_bucket=4, max_bucket=64)
        assert [p.bucket_for(n) for n in (1, 4, 5, 8, 9, 33, 64, 200)] == \
            [4, 4, 8, 8, 16, 64, 64, 64]
        assert EXACT.bucket_for(13) == 13 and EXACT.buckets() == ()

    @pytest.mark.parametrize("bad", [lambda: BucketPolicy(min_bucket=8, max_bucket=4),
                                     lambda: BucketPolicy(min_bucket=0),
                                     lambda: BucketPolicy().bucket_for(0)])
    def test_validation(self, bad):
        with pytest.raises(ValueError):
            bad()


class TestBoundedCompileCache:
    def test_lru_eviction_and_counters(self):
        c = BoundedCompileCache(maxsize=2)
        c.get_or_build("a", lambda: "A")
        c.get_or_build("b", lambda: "B")
        assert c.get_or_build("a", lambda: "A2") == "A"
        c.get_or_build("c", lambda: "C")                   # evicts "b"
        assert "b" not in c and "a" in c and "c" in c
        assert (c.hits, c.misses, c.evictions, c.compiles) == (1, 3, 1, 3)

    def test_lost_build_race_counts_as_miss(self):
        c = BoundedCompileCache(maxsize=4)
        entered, release = threading.Event(), threading.Event()

        def slow_build():
            entered.set()
            release.wait(10.0)
            return "slow"

        out = []
        t = threading.Thread(target=lambda: out.append(c.get_or_build("k", slow_build)))
        t.start()
        assert entered.wait(10.0)
        assert c.get_or_build("k", lambda: "fast") == "fast"
        release.set()
        t.join(10.0)
        assert out == ["fast"]
        assert (c.hits, c.misses, c.races) == (0, 2, 1)
        assert c.stats()["size"] == 1


class TestRegistry:
    def test_register_get_and_hash_guard(self):
        reg = ModelRegistry()
        m1, m2 = _tmodel(), _tmodel(n=4)
        s1 = _states(0)[1]
        assert reg.register("a", m1, s1) == 0
        snap = reg.get("a")
        assert snap.version == 0 and snap.model is m1
        s2 = m2.init(torch.Generator().manual_seed(1))
        with pytest.raises(ValueError, match="replace=True"):
            reg.register("a", m2, s2)
        reg.register("a", m2, s2, replace=True)
        assert reg.get("a").model is m2
        with pytest.raises(KeyError, match="no model registered"):
            reg.get("nope")

    def test_versions_promote_rollback(self):
        reg = ModelRegistry()
        reg.register("a", _tmodel(), _states(0)[1])
        assert reg.push("a", _states(1)[1]) == 1 and reg.get("a").version == 0
        assert reg.promote("a") == 1 and reg.get("a").version == 1
        assert reg.rollback("a") == 0 and reg.get("a").version == 0
        assert reg.n_versions("a") == 2
        with pytest.raises(IndexError):
            reg.promote("a", 7)
        reg2 = ModelRegistry()
        reg2.register("m", _tmodel(), _states(0)[1])
        with pytest.raises(RuntimeError, match="no previous live version"):
            reg2.rollback("m")

    @pytest.mark.parametrize("other", [dict(backend="torch"), dict(device="cuda")],
                             ids=["backend", "device"])
    def test_config_hash_tells_backend_and_device_apart(self, other):
        base = _tmodel()
        assert tregistry.model_config_hash(base) == tregistry.model_config_hash(_tmodel())
        assert tregistry.model_config_hash(base) != tregistry.model_config_hash(_tmodel(**other))


# ---------------------------------------------------------------------------
# engine: micro-batched serving, side by side with the reference
# ---------------------------------------------------------------------------

class TestMicroBatchedServing:
    def test_ragged_stream_matches_reference(self):
        (jsvc, jm, js), (tsvc, tm, ts) = _pair()
        xs = [_np(s, seed=i) for i, s in enumerate(SIZES)]
        for x in xs:                                       # one-shot path
            got = tsvc.transform("m", torch.from_numpy(x))
            _close(got, jsvc.transform("m", jnp.asarray(x)))
            # bit for bit the model's own call on the bucket-padded rows
            bucket = tsvc.buckets.bucket_for(x.shape[0])
            padded = np.concatenate([x, np.zeros((bucket - x.shape[0], 32), np.float32)])
            _close(got, tm.transform(ts, torch.from_numpy(padded))[:x.shape[0]], EXACT_TOL)
        jt = [jsvc.submit("m", jnp.asarray(x)) for x in xs]
        tt = [tsvc.submit("m", torch.from_numpy(x)) for x in xs]
        assert tsvc.batcher.queue_depth() == jsvc.batcher.queue_depth() == sum(SIZES)
        assert tsvc.flush() == jsvc.flush()
        for a, b in zip(tt, jt):
            _close(a.result(), b.result())
        jmet, tmet = jsvc.metrics(), tsvc.metrics()
        for k in ("served_rows", "padded_rows", "batches_run"):
            assert tmet[k] == jmet[k], k
        assert tmet["compile_cache"]["misses"] == jmet["compile_cache"]["misses"] == 4
        assert tmet["queue"]["queue_depth"] == 0
        assert tmet["autotunes"] == 4                      # one sweep per bucket, at register

    def test_oversize_request_chunks(self):
        (jsvc, _, _), (tsvc, tm, ts) = _pair()
        x = _np(81, seed=3)
        y = tsvc.transform("m", torch.from_numpy(x))
        assert tuple(y.shape) == (81, 8)
        _close(y, jsvc.transform("m", jnp.asarray(x)))
        assert tsvc.metrics()["batches_run"] == jsvc.metrics()["batches_run"] == 3
        assert tsvc.metrics()["padded_rows"] == jsvc.metrics()["padded_rows"]

    def test_backpressure_queue_full(self):
        svc, _, _ = _service(max_queue=16)
        svc.submit("m", torch.ones((10, 32)))
        with pytest.raises(QueueFull):
            svc.submit("m", torch.ones((7, 32)))
        assert svc.batcher.rejected == 1
        svc.flush()
        svc.submit("m", torch.ones((7, 32)))

    def test_never_admittable_request_is_value_error(self):
        mb = MicroBatcher(max_queue=8)
        with pytest.raises(ValueError, match="can never be admitted"):
            mb.submit("a", "x", 9)
        assert mb.rejected == 0 and mb.submit("a", "x", 8).rows == 8
        svc, _, _ = _service(max_queue=16)
        with pytest.raises(ValueError, match="can never be admitted"):
            svc.submit("m", torch.ones((17, 32)))

    def test_replace_mid_queue_fails_only_stale_tickets(self):
        svc, _, _ = _service()
        stale = [svc.submit("m", torch.ones((r, 32))) for r in (5, 3)]
        new_model = _tmodel(m=16)
        svc.register("m", new_model, _states(1, m=16)[1], replace=True)
        fresh = svc.submit("m", torch.ones((4, 16)))
        svc.flush()
        for t in stale:
            with pytest.raises(ValueError, match="replaced"):
                t.result()
        assert tuple(fresh.result().shape) == (4, 8)
        assert svc.batcher.queue_depth() == 0

    @pytest.mark.parametrize("x,exc", [(torch.ones((4, 31)), ValueError),
                                       (torch.ones((4,)), ValueError),
                                       (torch.ones((0, 32)), ValueError)])
    def test_request_validation(self, x, exc):
        svc, _, _ = _service()
        with pytest.raises(exc):
            svc.transform("m", x)
        with pytest.raises(KeyError):
            svc.transform("ghost", torch.ones((4, 32)))

    @pytest.mark.parametrize("backend,first", [("torch", 4), ("kernel", 0)])
    def test_warmup_builds_buckets(self, backend, first):
        """A kernel model's buckets are built at register, so warmup finds
        them all; a torch model's are built by warmup."""
        svc, _, _ = _service(_tmodel(backend=backend))
        assert svc.warmup("m") == first
        assert svc.warmup("m") == 0

    def test_microbatcher_fifo_groups(self):
        mb = MicroBatcher(max_queue=100)
        mb.submit("a", "x0", 1)
        mb.submit("b", "x1", 2)
        mb.submit("a", "x2", 3)
        groups = mb.drain()
        assert [g[0] for g in groups] == ["a", "b"]
        assert [p for p, _ in groups[0][1]] == ["x0", "x2"]
        assert mb.drain() == []


# ---------------------------------------------------------------------------
# engine: train-while-serve
# ---------------------------------------------------------------------------

class TestTrainWhileServe:
    def test_stream_promote_matches_reference_and_offline_fit(self):
        (jsvc, jm, js), (tsvc, tm, ts) = _pair()
        x = _np(64, seed=5)
        for blk in x.reshape(16, 4, 32):
            y = tsvc.serve_and_update("m", torch.from_numpy(blk))
            _close(y, jsvc.serve_and_update("m", jnp.asarray(blk)))
            _close(y, tm.transform(ts, torch.from_numpy(blk)), EXACT_TOL)  # live
        assert tsvc.registry.get("m").version == 0
        assert tsvc.staged_state("m") is not None
        assert tsvc.promote("m") == jsvc.promote("m") == 1
        promoted = tsvc.registry.get("m").state
        _assert_states(promoted, jsvc.registry.get("m").state, TRAJ)
        fitted = tm.fit(ts, torch.from_numpy(x), epochs=1)           # inside the port
        assert int(promoted.steps) == int(fitted.steps) == 16
        for a, b in zip(promoted.stages, fitted.stages):
            np.testing.assert_allclose(a.double().numpy(), b.double().numpy(), **SAME)
        probe = torch.from_numpy(x[:8])
        _close(tsvc.transform("m", probe), tm.transform(fitted, probe))
        tsvc.rollback("m")
        _close(tsvc.transform("m", probe), tm.transform(ts, probe), EXACT_TOL)
        # one fused program each; the port also built its 4 buckets at register
        assert jsvc.metrics()["compile_cache"]["misses"] == 1
        assert tsvc.metrics()["compile_cache"]["misses"] == 1 + 4

    def test_promote_and_rollback_never_rebuild(self):
        """Programs take the state as an argument: a promote or a rollback
        reuses every cached program (on the card: no re-capture)."""
        svc, tm, st = _service()
        blocks = _x(32, seed=6).reshape(8, 4, 32)
        svc.serve_and_update("m", blocks[0])
        n0, tunes = svc.cache.misses, svc.metrics()["autotunes"]
        assert n0 == 5 and tunes == 4                      # 4 buckets + 1 fused
        for blk in blocks[1:]:
            svc.serve_and_update("m", blk)
        svc.promote("m")
        svc.transform("m", _x(20, seed=7))
        svc.rollback("m")
        svc.transform("m", _x(20, seed=7))
        svc.registry.push("m", _states(3)[1])
        svc.promote("m", 2)
        svc.transform("m", _x(3, seed=8))
        assert (svc.cache.misses, svc.metrics()["autotunes"]) == (n0, tunes)

    def test_update_fraction_half(self):
        svc, tm, st = _service(update_fraction=0.5)
        blocks = _x(32, seed=6).reshape(8, 4, 32)
        for blk in blocks:
            svc.serve_and_update("m", blk)
        assert svc.metrics()["updates_applied"]["m"] == 4
        svc.promote("m")
        manual = st
        for i in range(1, 8, 2):
            manual = tm.update(manual, blocks[i])
        got = svc.registry.get("m").state
        assert int(got.steps) == int(manual.steps) == 4
        for a, b in zip(got.stages, manual.stages):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **SAME)

    def test_promote_without_staged_raises(self):
        svc, _, _ = _service()
        with pytest.raises(RuntimeError, match="nothing staged"):
            svc.promote("m")

    def test_fused_build_happens_outside_tws_lock(self):
        svc, tm, st = _service()
        held_at_build = []
        real = svc.cache.get_or_build

        def spy(key, build):
            lock = svc._tws_locks.get("m")
            held_at_build.append(lock.locked() if lock is not None else False)
            return real(key, build)

        svc.cache.get_or_build = spy
        for blk in _x(48, seed=7).reshape(12, 4, 32):
            _close(svc.serve_and_update("m", blk), tm.transform(st, blk), EXACT_TOL)
        svc.serve_and_update("m", _x(8, seed=8))           # a fresh shape after the lock exists
        assert held_at_build and not any(held_at_build)
        assert svc.metrics()["updates_applied"]["m"] == 13

    def test_threaded_stream_vs_promote_loses_no_update(self):
        """One thread streams blocks through serve_and_update while another
        hammers promote(), the interpreter switching threads often: the final
        live state is the fold of every block in stream order."""
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            self._stream_vs_promote()
        finally:
            sys.setswitchinterval(switch)

    def _stream_vs_promote(self):
        tm = _tmodel()
        svc = DRService(buckets=BucketPolicy(**BUCKETS))
        for run in range(4):
            name = f"m{run}"
            st = _states(run)[1]
            svc.register(name, tm, st)
            blocks = _x(32, seed=1000 + run).reshape(8, 4, 32)
            errors = []

            def stream(name=name, blocks=blocks):
                try:
                    for blk in blocks:
                        svc.serve_and_update(name, blk)
                except Exception as e:                    # noqa: BLE001
                    errors.append(repr(e))

            def promoter(name=name):
                for _ in range(16):
                    try:
                        svc.promote(name)
                    except RuntimeError:                  # nothing staged right now
                        pass

            ts = [threading.Thread(target=stream), threading.Thread(target=promoter)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(60.0)
            assert not any(t.is_alive() for t in ts) and not errors, (run, errors)
            try:
                svc.promote(name)
            except RuntimeError:
                pass
            assert svc.metrics()["updates_applied"][name] == 8
            manual = st
            for blk in blocks:
                manual = tm.update(manual, blk)
            final = svc.registry.get(name).state
            assert int(final.steps) == 8
            for a, b in zip(final.stages, manual.stages):
                np.testing.assert_allclose(a.numpy(), b.numpy(), **SAME, err_msg=f"run {run}")

    def test_staged_chain_is_its_own(self):
        """The staged chain never shares a tensor with the live state it
        was folded from, except a stage `update` leaves unchanged."""
        svc, tm, st = _service()
        svc.serve_and_update("m", _x(4, seed=9))
        staged = svc.staged_state("m")
        assert staged.stages[0] is st.stages[0]            # RP's R: static
        assert staged.stages[1] is not st.stages[1]
        ext = svc.extract_staged("m")
        assert ext.staged is staged and ext.chain_base is st and ext.updates == 1
        assert svc.staged_state("m") is None


# ---------------------------------------------------------------------------
# the autotuner's contract and content addressing
# ---------------------------------------------------------------------------

class TestAutotune:
    @pytest.mark.parametrize("rows,p,m", [(8, 16, 32), (1024, 256, 1024), (3, 7, 5)])
    def test_sweep_collapses_to_the_policy_tiles(self, rows, p, m):
        first = autotune.TileConfig(64, 256, 128)
        assert autotune.candidates(rows, p, m, first=first) == (first,)
        assert autotune.candidates(rows, p, m) == (autotune.KERNEL_CHOICE,)
        assert first.effective(rows, p, m) == autotune.KERNEL_CHOICE

    def test_single_candidate_skips_timing(self):
        built, calls = [], []

        def build(tiles):
            built.append(tiles)
            return lambda *a: calls.append(a)

        prog = autotune.tune([autotune.TileConfig()], build, (None, torch.zeros(2)))
        assert built == [autotune.TileConfig()] and calls == [] and prog.device == "cpu"
        assert prog.tiles == autotune.TileConfig()

    def test_a_timed_race_is_refused(self):
        cands = [autotune.TileConfig(64, 128, 128), autotune.TileConfig(256, 128, 128)]
        with pytest.raises(NotImplementedError, match="A4a"):
            autotune.tune(cands, lambda t: (lambda x: x), (torch.ones(2),))

    def test_register_caches_one_tuned_program_per_bucket(self):
        tm = _tmodel()
        exe = tm.execution
        svc, _, _ = _service(tm)
        snap = svc.registry.get("m")
        for b in svc.buckets.buckets():
            prog = svc._transform_fn(snap, b, torch.float32)
            assert isinstance(prog, autotune.TunedProgram)
            assert prog.tiles == autotune.TileConfig(exe.tmm_block_m, exe.tmm_block_p,
                                                     exe.tmm_block_k)
        assert svc.cache.misses == svc.metrics()["autotunes"] == 4


class TestStateHash:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_port_state_hashes_as_the_reference(self, dtype):
        js = jax_small_model().init(jax.random.PRNGKey(4))
        js = js._replace(stages=(js.stages[0], js.stages[1].astype(dtype)),
                         steps=jnp.int32(7))
        ts = bridge.from_reference(js, device="cpu")
        assert ts.stages[1].dtype == getattr(torch, dtype)
        want = jdurability.state_hash(js)
        assert durability.state_hash(ts) == want
        assert durability.state_hash(durability.host_state(ts)) == want

    def test_hash_tells_bytes_and_steps_apart(self):
        _, ts = _states(0)
        h = durability.state_hash(ts)
        assert durability.state_hash(ts._replace(steps=ts.steps + 1)) != h
        b = ts.stages[1].clone()
        b[0, 0] += 1.0
        assert durability.state_hash(ts._replace(stages=(ts.stages[0], b))) != h
        copy = durability.host_state(ts)
        assert copy.stages[1] is not ts.stages[1] and durability.state_hash(copy) == h


@pytest.mark.parametrize("call,item", [
    (lambda: DRService(mesh=object()), "A10"),
    (lambda: compress.compress_sync([], [], compress.CompressConfig(), ("data",)), "A10"),
    (lambda: DRService().register("e", _tmodel(), _states(0)[1], ensemble=2), "A4c"),
    # the LM steps run with mesh=None only (tests/test_torch_lm_zoo.py)
    (lambda: DRService().prefill_step(None, object(), None, None, 8), "A10"),
    (lambda: DRService().decode_step(None, object(), None, None, None), "A10"),
    (lambda: DRService().lm_prefill(None, object(), None, None, 8), "A10"),
    (lambda: DRService().lm_decode(None, object(), None, None, None), "A10"),
    (lambda: DeadlineScheduler(DRService(), start=False).lm_prefill(None, object(), None, None,
                                                                    8), "A10"),
], ids=["mesh", "compress_sync", "ensemble", "prefill_step", "decode_step", "lm_prefill",
        "lm_decode", "scheduler_lm_prefill"])
def test_not_ported_paths_name_their_item(call, item):
    with pytest.raises(NotImplementedError, match=item):
        call()


def test_serve_sources_pass_the_path_scoped_checkers():
    """clock-discipline and blocking-under-lock scope themselves to the JAX
    package's serve/ by path, so the CLI skips the port: run them on the
    port's serve modules here, each under the scope rule it applies to the
    reference's twin.  No finding survives but the waiver the reference keeps."""
    from repro.analysis.checkers.blocking_under_lock import BlockingUnderLock
    from repro.analysis.checkers.clock_discipline import ClockDiscipline
    from repro.analysis.source import SourceUnit

    paths = sorted((REPO / "src" / "repro_torch" / "serve").glob("*.py"))
    assert len(paths) >= 9
    for checker in (ClockDiscipline(), BlockingUnderLock()):
        units = {}
        found = []
        for p in paths:
            rel = p.relative_to(REPO).as_posix()
            if not checker.applies(rel.replace("repro_torch/", "repro/")):
                continue
            units[rel] = unit = SourceUnit.parse(rel, p.read_text())
            found += list(checker.check(unit))
        found += list(checker.finalize())
        left = [f for f in found if not units[f.path].allows(f.line, f.checker)]
        assert left == [], left


# ---------------------------------------------------------------------------
# the deadline scheduler (tests/test_scheduler.py, DR parts)
# ---------------------------------------------------------------------------

class TestClock:
    def test_monotonic_now_advances(self):
        c = MonotonicClock()
        a, b = c.now(), c.now()
        assert b >= a

    def test_virtual_advance_and_backwards(self):
        c = VirtualClock(start_ms=100.0)
        assert c.now() == 100.0 and c.advance(2.5) == 102.5 and c.now() == 102.5
        with pytest.raises(ValueError):
            c.advance(-1.0)

    def test_virtual_advance_wakes_parked_waiter(self):
        c = VirtualClock()
        cond = threading.Condition()
        woke = threading.Event()

        def park():
            with cond:
                c.wait(cond, timeout_ms=10.0)
            woke.set()

        th = threading.Thread(target=park, daemon=True)
        th.start()
        while not cond._waiters:
            pass
        c.advance(1.0)
        assert woke.wait(5.0)
        th.join(5.0)

    def test_no_sleep_anywhere_in_these_tests(self):
        assert ("sleep" + "(") not in Path(__file__).read_text()


class TestDeadlineFlush:
    def test_single_subbucket_request_answered_at_deadline(self):
        D = 25.0
        with PortHarness() as h:
            x = _x(3, seed=1)
            t = h.submit(x, max_delay_ms=D)
            assert h.poll() == 0 and not t.done
            assert h.advance(D - 0.01) == 0 and not t.done
            assert h.advance(0.01) == 1 and t.done
            _close(t.result(), h.expect(x), TIGHT)

    @pytest.mark.parametrize("default,explicit,at", [(7.0, None, 7.0), (1000.0, 2.0, 2.0)])
    def test_default_and_explicit_deadlines(self, default, explicit, at):
        with PortHarness(default_max_delay_ms=default) as h:
            t = h.submit(_x(2), max_delay_ms=explicit)
            h.advance(at - 0.01)
            assert not t.done
            h.advance(0.01)
            assert t.done

    def test_bucket_fill_flushes_before_deadline(self):
        with PortHarness(flush_rows=8, default_max_delay_ms=1000.0) as h:
            t1 = h.submit(_x(5, seed=1))
            assert h.poll() == 0 and not t1.done
            t2 = h.submit(_x(3, seed=2))
            assert h.poll() >= 1 and t1.done and t2.done and h.now() == 0.0

    def test_oldest_deadline_governs_the_bucket(self):
        with PortHarness() as h:
            t1 = h.submit(_x(3, seed=1), max_delay_ms=10.0)
            t2 = h.submit(_x(2, seed=2), max_delay_ms=1000.0)
            b0 = h.service.batches_run
            h.advance(10.0)
            assert t1.done and t2.done and h.service.batches_run - b0 == 1

    def test_deadline_flush_ordering_and_next_deadline(self):
        with PortHarness() as h:
            h.service.register("m2", h.model, h.state)
            assert h.scheduler.next_deadline() is None
            ta = h.submit(_x(2, seed=1), max_delay_ms=50.0)
            tb = h.submit(_x(2, seed=2), name="m2", max_delay_ms=20.0)
            assert h.scheduler.next_deadline() == 20.0
            h.advance(20.0)
            assert tb.done and not ta.done and h.scheduler.next_deadline() == 50.0
            h.advance(30.0)
            assert ta.done and h.scheduler.next_deadline() is None

    def test_partial_bucket_flush_pads_to_bucket(self):
        with PortHarness() as h:
            t = h.submit(_x(3, seed=3), max_delay_ms=1.0)
            h.advance(1.0)
            assert t.done and tuple(t.result().shape) == (3, 8)
            assert h.service.padded_rows == 1
            assert h.service.cache.misses == 4             # the buckets built at register

    def test_compile_counts_match_demand_flush(self):
        with PortHarness() as h:
            for i, s in enumerate(SIZES):
                t = h.submit(_x(s, seed=i), max_delay_ms=1.0)
                h.advance(1.0)
                _close(t.result(), h.expect(_x(s, seed=i)), TIGHT)
            assert h.service.cache.misses == 4

    def test_wake_lead_flushes_early_and_counts_met(self):
        with PortHarness(wake_lead_ms=2.0) as h:
            t = h.submit(_x(2), max_delay_ms=10.0)
            assert h.advance(7.9) == 0 and not t.done
            assert h.advance(0.1) == 1 and t.done
            m = h.service.metrics()
            assert (m["deadline_met"], m["deadline_missed"]) == (1, 0)

    def test_backpressure_passes_through(self):
        with PortHarness(max_queue=8) as h:
            h.submit(_x(6, seed=1))
            with pytest.raises(QueueFull):
                h.submit(_x(3, seed=2))
            h.advance(10.0)
            h.submit(_x(3, seed=2))

    def test_demand_flush_composes_with_scheduler(self):
        with PortHarness() as h:
            t = h.submit(_x(2), max_delay_ms=100.0)
            h.service.flush()
            assert t.done and h.advance(100.0) == 0


class TestThreadedLoop:
    def test_advance_wakes_loop_and_resolves(self):
        with PortHarness(threaded=True, default_max_delay_ms=8.0) as h:
            x = _x(3, seed=1)
            t = h.submit(x)
            h.advance(8.0)
            assert t.wait(10.0)
            _close(t.result(), h.expect(x), TIGHT)

    def test_fill_flushes_without_time_passing(self):
        with PortHarness(threaded=True, flush_rows=8, default_max_delay_ms=1e6) as h:
            t1, t2 = h.submit(_x(5, seed=1)), h.submit(_x(3, seed=2))
            assert t1.wait(10.0) and t2.wait(10.0) and h.now() == 0.0

    def test_shutdown_drains_queue(self):
        h = PortHarness(threaded=True, default_max_delay_ms=1e6)
        tickets = [h.submit(_x(2, seed=i)) for i in range(5)]
        h.shutdown()
        for i, t in enumerate(tickets):
            assert t.done
            _close(t.result(), h.expect(_x(2, seed=i)), TIGHT)

    def test_shutdown_without_drain_leaves_pending(self):
        h = PortHarness(threaded=True, default_max_delay_ms=1e6)
        t = h.submit(_x(2))
        h.shutdown(drain=False)
        assert not t.done
        with pytest.raises(RuntimeError, match="not served yet"):
            t.result()

    def test_submit_after_shutdown_raises(self):
        h = PortHarness(threaded=True)
        h.shutdown()
        with pytest.raises(SchedulerClosed):
            h.submit(_x(2))
        with pytest.raises(SchedulerClosed):
            h.scheduler.start()

    def test_shutdown_idempotent_and_loopless_drain(self):
        h = PortHarness(threaded=False, default_max_delay_ms=1e6)
        t = h.submit(_x(2))
        h.shutdown()
        assert t.done
        h.shutdown()


def _schedule(h, xs):
    """One virtual-clock schedule: deadline flushes, a demand flush, a miss,
    a fill, a second name — driven through either harness."""
    h.service.register("m2", h.model, h.state)
    h.submit(xs[0], max_delay_ms=5.0)
    h.submit(xs[1], max_delay_ms=1.0)
    h.advance(1.0)
    h.submit(xs[2], name="m2", max_delay_ms=3.0)
    h.advance(9.0)                                       # m2 missed by 6 ms
    h.service.submit("m", xs[3])                          # no deadline
    h.advance(2.5)
    h.service.flush()
    h.submit(xs[4], max_delay_ms=50.0)
    h.submit(xs[5], max_delay_ms=50.0)                    # fills 32 rows
    h.advance(0.5)
    h.submit(xs[6], max_delay_ms=4.0)
    h.advance(4.0)
    return h.service.metrics()


class TestSLO:
    def test_report_matches_reference_under_the_same_schedule(self):
        sizes = [3, 9, 2, 5, 20, 12, 1]
        xs = [_np(s, seed=i) for i, s in enumerate(sizes)]
        with JaxHarness() as jh, PortHarness() as th:
            jm = _schedule(jh, [jnp.asarray(x) for x in xs])
            tm = _schedule(th, [torch.from_numpy(x) for x in xs])
        assert tm["slo"] == jm["slo"]
        for k in ("deadline_met", "deadline_missed", "served_rows", "padded_rows",
                  "batches_run", "queue"):
            assert tm[k] == jm[k], k
        assert tm["deadline_missed"] >= 1 and len(tm["slo"]["m"]) >= 3

    def test_exact_latency_under_virtual_clock(self):
        with PortHarness(default_max_delay_ms=10.0) as h:
            h.submit(_x(3, seed=1))
            h.advance(7.0)
            h.service.flush()
            cell = h.service.slo.cell("m", 4)
            assert cell.queue_delay.count == 1
            for stats in (cell.queue_delay, cell.e2e):
                assert stats.percentile(50) == stats.percentile(99) == stats.max_ms == 7.0
            assert (cell.deadline_met, cell.deadline_missed) == (1, 0)

    @pytest.mark.parametrize("at,met,missed", [(9.0, 0, 1), (5.0, 1, 0)])
    def test_deadline_met_or_missed(self, at, met, missed):
        with PortHarness() as h:
            h.submit(_x(2, seed=1), max_delay_ms=5.0)
            h.advance(at)
            m = h.service.metrics()
            assert (m["deadline_met"], m["deadline_missed"]) == (met, missed)
            assert h.service.slo.cell("m", 4).e2e.percentile(50) == at

    def test_per_bucket_cells(self):
        with PortHarness() as h:
            h.submit(_x(3, seed=1), max_delay_ms=1.0)
            h.submit(_x(9, seed=2), max_delay_ms=1.0)
            h.advance(1.0)
            slo = h.service.metrics()["slo"]
            assert sorted(slo["m"]) == [4, 16]
            assert slo["m"][4]["e2e"]["count"] == 1 and slo["m"][16]["deadline_met"] == 1

    def test_demand_traffic_has_no_deadline_counts(self):
        with PortHarness() as h:
            h.service.submit("m", _x(2))
            h.advance(3.0)
            h.service.flush()
            cell = h.service.slo.cell("m", 4)
            assert cell.e2e.count == 1 and cell.e2e.percentile(50) == 3.0
            assert (cell.deadline_met, cell.deadline_missed, cell.miss_rate) == (0, 0, None)

    def test_latency_stats_percentiles_window_histogram(self):
        s = LatencyStats()
        for v in range(1, 101):
            s.record(float(v))
        assert (s.percentile(50), s.percentile(99), s.percentile(100), s.percentile(0)) == \
            (50.0, 99.0, 100.0, 1.0)
        assert s.count == 100 and s.mean_ms == 50.5
        w = LatencyStats(window=4)
        for v in (1.0, 2.0, 3.0, 100.0, 100.0, 100.0, 100.0):
            w.record(v)
        assert w.count == 7 and w.percentile(50) == 100.0
        hs = LatencyStats()
        for v in (0.0, 0.2, 0.25, 0.5, 3.0):
            hs.record(v)
        assert hs.histogram() == {"le_0.25ms": 3, "le_0.5ms": 1, "le_4ms": 1}
        assert LatencyStats().histogram() == {} and LatencyStats().percentile(50) is None

    def test_tracker_report_shape(self):
        tr = SLOTracker()
        tr.record("a", 8, queue_delay_ms=1.0, e2e_ms=2.0, deadline_ok=True)
        tr.record("a", 8, queue_delay_ms=3.0, e2e_ms=4.0, deadline_ok=False)
        rep = tr.report()
        assert rep["a"][8]["deadline_miss_rate"] == 0.5
        assert rep["a"][8]["queue_delay"]["p50_ms"] == 1.0
        assert tr.deadline_counts() == (1, 1)


class TestStepTraffic:
    def test_step_runs_at_flush_and_shares_queue(self):
        with PortHarness() as h:
            ran = []
            t = h.submit_step("lm", "prefill", lambda a, b: ran.append(1) or (a + b), 2, 3,
                              rows=4, max_delay_ms=5.0)
            assert h.service.batcher.queue_depth() == 4 and not ran
            h.advance(5.0)
            assert t.result() == 5 and ran == [1]
            assert h.service.metrics()["slo"]["lm"]["prefill"]["deadline_met"] == 1

    def test_step_and_dr_interleave_one_flush(self):
        with PortHarness() as h:
            td = h.submit(_x(3, seed=1), max_delay_ms=2.0)
            ts = h.submit_step("lm", "decode", lambda: "tok", max_delay_ms=2.0)
            h.advance(2.0)
            assert td.done and ts.result() == "tok"
            assert set(h.service.metrics()["slo"]) == {"m", "lm"}

    def test_step_failure_fails_only_its_ticket(self):
        with PortHarness() as h:
            def boom():
                raise RuntimeError("step exploded")
            ts = h.submit_step("lm", "decode", boom, max_delay_ms=1.0)
            tok = h.submit_step("lm", "decode", lambda: "tok", max_delay_ms=1.0)
            td = h.submit(_x(2), max_delay_ms=1.0)
            h.advance(1.0)
            assert tuple(td.result().shape) == (2, 8) and tok.result() == "tok"
            with pytest.raises(RuntimeError, match="step exploded"):
                ts.result()


class TestSelectiveDrain:
    def test_drain_keys_preserves_fifo_for_rest(self):
        mb = MicroBatcher(max_queue=100)
        mb.submit("a", "a0", 1)
        mb.submit("b", "b0", 2)
        mb.submit("a", "a1", 3)
        got = mb.drain(keys=["a"])
        assert [k for k, _ in got] == ["a"] and [p for p, _ in got[0][1]] == ["a0", "a1"]
        assert [k for k, _ in mb.drain()] == ["b"]

    def test_pending_by_key_rows_and_earliest_deadline(self):
        mb = MicroBatcher(max_queue=100)
        mb.submit("a", "p", 2, deadline=50.0)
        mb.submit("a", "q", 3, deadline=20.0)
        mb.submit("b", "r", 1)
        assert mb.pending_by_key() == {"a": (5, 20.0), "b": (1, None)}
        mb.drain()
        assert mb.pending_by_key() == {}


class TestRegistryFaultInjection:
    def test_rollback_past_version_zero_raises_cleanly(self):
        svc, _, _ = _service()
        with pytest.raises(RuntimeError, match="no previous live version"):
            svc.rollback("m")
        assert svc.registry.get("m").version == 0

    def test_concurrent_transform_vs_promote_rollback(self):
        """Reader threads serve while a mutator loops push / promote /
        rollback: every reply is the output of exactly one registered
        state — never a torn (model, state) mix."""
        svc, tm, s0 = _service()
        s1 = _states(1)[1]
        x = _x(5, seed=7)
        y0 = svc.transform("m", x)
        svc.registry.push("m", s1)
        svc.promote("m", 1)
        y1 = svc.transform("m", x)
        svc.rollback("m")
        assert not torch.equal(y0, y1)
        stop, errors = threading.Event(), []

        def reader():
            try:
                while not stop.is_set():
                    y = svc.transform("m", x)
                    if not (torch.equal(y, y0) or torch.equal(y, y1)):
                        errors.append("torn read")
                        return
            except Exception as e:                        # noqa: BLE001
                errors.append(repr(e))

        def mutator():
            try:
                for i in range(30):
                    v = svc.registry.push("m", s1 if i % 2 == 0 else s0)
                    svc.promote("m", v)
                    if i % 3 == 0:
                        svc.rollback("m")
            except Exception as e:                        # noqa: BLE001
                errors.append(repr(e))
            finally:
                stop.set()

        readers = [threading.Thread(target=reader) for _ in range(4)]
        mut = threading.Thread(target=mutator)
        for th in readers + [mut]:
            th.start()
        mut.join(60.0)
        stop.set()
        for th in readers:
            th.join(60.0)
        assert not any(th.is_alive() for th in readers + [mut]) and not errors, errors
        assert svc.registry.n_versions("m") == 32


# ---------------------------------------------------------------------------
# CapturedProgram's reload decision (an in-place write to a registered state)
# ---------------------------------------------------------------------------

def test_a_buffer_reloads_after_an_in_place_write():
    from repro_torch.serve.engine import needs_reload

    t = torch.zeros((4, 3))
    version = t._version
    assert not needs_reload(t, t, version)          # the same tensor, untouched
    t.add_(1.0)
    assert needs_reload(t, t, version)              # the same tensor, written in place
    assert not needs_reload(t, t, t._version)       # ... and once reloaded, not again
    assert needs_reload(t.clone(), t, t._version)   # another tensor
