"""The port's spans (`repro_torch.obs`) on the CPU: off, they record nothing;
under `torch.profiler.profile` (every thread's events, as the benchmark asks
for them) a train step and a request served through `DeadlineScheduler`
record the spans of the train step's phases, the scheduler's loop, the LM
step and the engine's DR calls; children nest in their parents on their
thread, a ticket's admission and step share its request id, a span's CPU
time is at most its wall time, and each span starts within 1 ms of its
`user_annotation` in the exported chrome trace.  The spans of the captured
DR program and of the kernels' launches run only on the card."""

import dataclasses
import json
import statistics
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch import dr as tdr
from repro_torch import obs
from repro_torch.configs import registry as t_registry
from repro_torch.core.execution import Execution
from repro_torch.data import synthetic as t_synthetic
from repro_torch.models import api as t_api
from repro_torch.models.config import DRFrontendSpec
from repro_torch.serve import BucketPolicy, DeadlineScheduler, DRService, MonotonicClock
from repro_torch.train import train_step as t_ts
from repro_torch.train import trainer as t_trainer

CPU = Execution(device="cpu")
CPU_KERNEL = Execution(backend="kernel", device="cpu")

TRAIN = {"train.step", "train.feed", "train.dr_frontend", "train.forward", "train.backward",
         "train.optimizer", "train.dr_update"}
SERVE = {"sched.park", "sched.scan", "sched.flush", "sched.admit", "serve.step",
         "dr.serve_and_update", "dr.transform", "dr.promote"}
CHILDREN = {"train.feed": "train.step", "train.dr_frontend": "train.step",
            "train.forward": "train.step", "train.backward": "train.step",
            "train.optimizer": "train.step", "train.dr_update": "train.step",
            "serve.step": "sched.flush"}


def _train():
    """(step, state, batch) of hubert SMOKE with the DR front end, f32."""
    arch = dataclasses.replace(t_registry.get_smoke("hubert_xlarge"), compute_dtype="float32",
                               dr_frontend=DRFrontendSpec(p=16, n=8))
    cfg = t_ts.TrainConfig(arch=arch)
    state = t_ts.init_state(torch.Generator().manual_seed(0), cfg, execution=CPU)
    data = t_synthetic.TokenStreamConfig(vocab_size=arch.vocab_size, seq_len=8, global_batch=2)
    return (t_ts.make_train_step(cfg, execution=CPU_KERNEL), state,
            t_trainer.make_batch(arch, data, 0))


class _ParkClock(MonotonicClock):
    """A real clock whose `parked` is set while the scheduler's loop waits
    on it (set before the wait releases the loop's lock)."""

    def __init__(self):
        self.parked = threading.Event()

    def wait(self, cond, timeout_ms):
        self.parked.set()
        try:
            return super().wait(cond, timeout_ms)
        finally:
            self.parked.clear()


def _serve():
    """(serve(): two requests served as the benchmark serves one, their
    tickets; the scheduler; its clock)."""
    clock = _ParkClock()
    svc = DRService(buckets=BucketPolicy(min_bucket=4, max_bucket=8), clock=clock)
    model = tdr.DRModel(stages=(tdr.RPStage(32, 16), tdr.EASIStage.rotation(16, 8, mu=1e-3)),
                        execution=tdr.Execution(backend="kernel", device="cpu"), block_size=4)
    svc.register("dr", model, model.init(torch.Generator().manual_seed(0)))
    sched = DeadlineScheduler(svc, default_max_delay_ms=0.0)
    cfg = t_registry.get_smoke("smollm_135m")
    params = t_api.init_params(torch.Generator().manual_seed(0), cfg, execution=CPU)
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    rows = torch.randn(8, 32, generator=torch.Generator().manual_seed(2))

    def serve():
        tickets = []
        for update in (True, False):
            red = svc.serve_and_update("dr", rows) if update else svc.transform("dr", rows)
            assert red.shape == (8, 8)
            tickets.append(sched.lm_prefill(cfg, None, params, {"tokens": prompts}, 16,
                                            max_delay_ms=0.0, execution=CPU))
        svc.promote("dr")
        for t in tickets:
            assert t.wait(60.0)
            logits, _ = t.result()
            assert logits.shape == (2, cfg.vocab_size)
        return tickets

    return serve, sched, clock


def _profile():
    from torch.profiler import ProfilerActivity, profile

    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=[ProfilerActivity.CPU], experimental_config=cfg)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """(the spans, the chrome trace, the tickets) of a train step and two
    requests run under a profile, which ends once the scheduler's loop has
    parked after them and been stopped."""
    step, state, batch = _train()
    serve, sched, clock = _serve()
    try:
        step(state, batch)
        serve()                       # builds and warms every program
        obs.clear()
        with _profile() as prof:
            step(state, batch)
            tickets = serve()
            # the loop parks after the last flush; stopping it closes that park
            assert clock.parked.wait(30.0)
            sched.shutdown()
        got = obs.spans()
    finally:
        sched.shutdown()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    return got, json.loads(path.read_text()), tickets


def test_the_profiler_flag_the_spans_read_exists():
    """The spans switch on with `torch.autograd.profiler._is_profiler_enabled`:
    a torch without it fails here rather than silently turning them off."""
    from torch.autograd import profiler

    assert isinstance(profiler._is_profiler_enabled, bool)
    assert not profiler._is_profiler_enabled
    with _profile():
        assert profiler._is_profiler_enabled
    assert not profiler._is_profiler_enabled


def test_with_no_profile_nothing_is_recorded():
    step, state, batch = _train()
    serve, sched, _ = _serve()
    obs.clear()
    try:
        step(state, batch)
        tickets = serve()
    finally:
        sched.shutdown()
    assert obs.spans() == []
    assert all(t.req is None for t in tickets)
    assert obs.span("a") is obs.span("b") and obs.request_id() is None
    assert obs.totals("train.step") == (0, 0.0, 0.0)


def test_a_traced_step_and_requests_record_every_span(traced):
    spans, _, _ = traced
    names = {s.name for s in spans}
    assert TRAIN | SERVE <= names, sorted(TRAIN | SERVE - names)
    count = lambda n: sum(s.name == n for s in spans)  # noqa: E731
    assert count("train.step") == count("train.forward") == count("train.backward") == 1
    assert count("serve.step") == count("sched.admit") == 2
    assert count("dr.serve_and_update") == count("dr.transform") == count("dr.promote") == 1


def test_children_nest_in_their_parents(traced):
    spans, _, _ = traced
    by_index = {s.index: s for s in spans}
    for s in spans:
        if s.parent is None:
            continue
        p = by_index[s.parent]
        assert p.tid == s.tid
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (p, s)
        assert s.end_ns - s.start_ns <= p.end_ns - p.start_ns
    for s in spans:
        if s.name in CHILDREN:
            assert by_index[s.parent].name == CHILDREN[s.name], s
    assert all(s.parent is None for s in spans if s.name in ("train.step", "sched.admit"))


def test_a_ticket_s_admission_and_step_share_its_request_id(traced):
    spans, _, tickets = traced
    admit = {s.req: s for s in spans if s.name == "sched.admit"}
    steps = {s.req: s for s in spans if s.name == "serve.step"}
    reqs = [t.req for t in tickets]
    assert None not in reqs and len(set(reqs)) == 2
    assert set(admit) == set(steps) == set(reqs)
    for r in reqs:
        assert admit[r].start_ns <= steps[r].start_ns
        assert admit[r].tid != steps[r].tid        # the client's thread, the loop's


def test_cpu_time_is_at_most_wall_time(traced):
    spans, _, _ = traced
    assert all(0 <= s.cpu_ns <= s.end_ns - s.start_ns for s in spans)


def test_each_span_starts_within_1_ms_of_its_annotation_in_the_trace(traced):
    """Each span's `user_annotation` in the exported chrome trace (`ts` +
    `baseTimeNanoseconds`, Unix time) lies inside the span to 1 ms at
    either end, and the starts agree within 1 ms at the median: a span
    reads its clock, then opens its `record_function`, so a thread
    preempted in between (a loaded host) starts one annotation late."""
    spans, raw, _ = traced
    base_us = raw["baseTimeNanoseconds"] / 1e3
    marks = {}
    for e in raw["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            a0 = float(e["ts"]) + base_us
            marks.setdefault(e["name"], []).append((a0, a0 + float(e["dur"])))
    gaps = []
    for name in TRAIN | SERVE:
        mine = sorted((s.start_ns / 1e3, s.end_ns / 1e3) for s in spans if s.name == name)
        theirs = sorted(marks.get(name, []))
        assert len(theirs) == len(mine), name
        for (s0, s1), (a0, a1) in zip(mine, theirs):
            assert s0 - 1e3 <= a0 and a1 <= s1 + 1e3, (name, a0 - s0, a1 - s1)
            gaps.append(abs(a0 - s0))
    assert statistics.median(gaps) <= 1e3, gaps


def test_totals_sum_the_spans_of_a_name_and_clear_empties_the_store():
    obs.clear()
    with _profile():
        for _ in range(3):
            with obs.span("t.outer"):
                with obs.span("t.inner", req=7):
                    torch.ones(64).sum()
    outer, inner = obs.totals("t.outer"), obs.totals("t.inner")
    assert outer.count == inner.count == 3
    assert 0.0 < inner.wall_ms <= outer.wall_ms and 0.0 <= outer.off_cpu_ms <= outer.wall_ms
    spans = obs.spans()
    parents = {s.index: s.name for s in spans}
    assert all(s.req == 7 and parents[s.parent] == "t.outer" for s in spans
               if s.name == "t.inner")
    assert sum(s.end_ns - s.start_ns for s in spans if s.name == "t.outer") / 1e6 == \
        pytest.approx(outer.wall_ms)
    obs.clear()
    assert obs.spans() == [] and obs.totals("t.outer") == (0, 0.0, 0.0)


def test_the_dp_compressed_step_records_the_same_phases_and_its_sync(tmp_path):
    """`make_dp_compressed_step` on two gloo ranks: the train step's phase
    names, `train.grad_sync` beside them, the DR front end inside the loss."""
    from torch_mesh_ranks import spawn

    for rank in spawn("dp_spans", 2, tmp_path, {}, timeout=200):
        assert not rank["jax_loaded"]
        parent = dict(rank["spans"])
        assert {"train.step", "train.feed", "train.forward", "train.backward",
                "train.grad_sync", "train.optimizer", "train.dr_frontend"} <= set(parent)
        assert all(parent[n] == "train.step" for n in ("train.feed", "train.forward",
                                                         "train.backward", "train.grad_sync",
                                                         "train.optimizer"))
        assert parent["train.dr_frontend"] == "train.forward"
