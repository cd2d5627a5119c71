"""The serving driver: one client keeping `in_flight` requests open in a
closed loop against the port's serving engine.

A request is `sequences` streams, each `prefix_rows` front-end rows
(patches or frames) and `text_tokens` tokens. A configuration with a
front end has a DR unit, and its rows go through the `DRService` (kernel
backend, one bucket of exactly the request's rows): `serve_and_update`
(answered with the live DR state while the same rows train the staged
one, `promote()` after every `promote_every`-th request) or `transform`
(the live state, no update); a text model's request is its tokens alone.
The stream then goes to `DeadlineScheduler.lm_prefill` with no batching
delay, its cache sized for the prompt and `decode_steps` more positions
(0 where the traffic sets none), and a causal model's streams decode
`decode_steps` greedy tokens through `DeadlineScheduler.lm_decode`, each
step's token the argmax of the last logits, fed back on the device with
no read to the host between steps. The request is done when its answer is
on the host: each stream's tokens (the first, the argmax of the last
position's logits, and one a decode step) for a causal model, the last
position's logits for an encoder. Latency runs from when the client
issued the request to then; a request's tokens are its positions through
the model's layers, the prompt's and one a stream a decode step.

Set-up registers the DR model (on the card this captures the bucket's
program and races its tiles), starts the scheduler and serves `warmup`
requests through the same path, which builds and warms every program and
shape the window uses; they are part of the DR state's history.  Once
the window has closed and the program is stopped, the reference replays
the DR state's whole history from the seed and recomputes a sample of the
window's requests drawn from the seed: the reduced rows, the last
position's logits and, teacher-forced along the greedy tokens of the
program's own logits, every decoded position's logits in one forward pass
over the prompt and them, and the final live and staged B.  The reference
is the module the configuration's `reference` key names.
"""

from __future__ import annotations

import collections
import math
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import arch as arch_mod
from portbench import bench, common, devtrace, flops, generate, weights
from portbench.bench import Outcome, Run


def _kept(seed: int, i: int, every: int) -> bool:
    """Whether request i's answer is kept for the check (drawn from the seed)."""
    return zlib.crc32(f"{seed}:{i}".encode()) % every == 0


def program(r: Run):
    from repro_torch.core import dr_unit
    from repro_torch.core.execution import Execution
    from repro_torch.dr.model import ModelState
    from repro_torch.kernels.autotune import TunedProgram
    from repro_torch.serve import BucketPolicy, DeadlineScheduler, DRService

    a, tr, dev = r.arch, r.traffic, r.device
    cfg = arch_mod.port_config(a)
    exe = Execution(backend="kernel", device=dev.type)
    spec = a.dr_frontend
    params = weights.draw_params(a, r.seed, dev)
    n, p_rows, t_tok = tr["sequences"], tr["prefix_rows"], tr["text_tokens"]
    steps = tr.get("decode_steps", 0)
    rows, s_total = n * p_rows, p_rows + t_tok
    update = tr["dr"] == "serve_and_update"
    every = tr["promote_every"]
    if steps and not a.causal:
        raise ValueError(f"{a.name} is an encoder: it decodes nothing")
    prog = model = None
    if spec is not None:
        dcfg = dr_unit.DRConfig(kind=spec.kind, m=a.frontend_dim, p=spec.p, n=spec.n,
                                mu=spec.mu, block_size=1,
                                bypass_whitening=spec.bypass_whitening)
        model = dr_unit.from_legacy(dcfg, execution=exe)
        rr, b0 = weights.draw_dr(a, r.seed, dev)
        svc = DRService(buckets=BucketPolicy(min_bucket=rows, max_bucket=rows),
                        update_fraction=1.0)
        svc.register("dr", model, ModelState(stages=(rr, b0.clone()),
                                             steps=torch.zeros((), dtype=torch.int32),
                                             trainable=model.trainable_mask))
        common.sync(dev)
        r.log(f"[set-up] {common.now() - r.t_start:.2f} s: weights drawn, DR model registered")
        prog = svc._transform_fn(svc.registry.get("dr"), rows, torch.float32)
        if isinstance(prog, TunedProgram):
            race = {str(t): ms for t, ms in prog.timings_ms.items()}
            r.log(f"[set-up] tile race for the {rows}-row bucket: winner {prog.tiles}; ms a "
                  f"call {race}")
        else:
            r.log(f"[set-up] no tile race for the {rows}-row bucket on {dev.type}")
    else:
        svc = DRService(buckets=BucketPolicy())
        common.sync(dev)
        r.log(f"[set-up] {common.now() - r.t_start:.2f} s: weights drawn; no DR unit")
    if r.fault == "unchanged":
        def fused_fn(snap, x):
            mdl = snap.model
            return lambda live, staged, xb: (mdl.transform(live, xb), staged.stages)
        svc._fused_update_fn = fused_fn
    sched = DeadlineScheduler(svc, default_max_delay_ms=0.0)
    mix = generate.mixing(r.seed, a.frontend_dim, dev) if p_rows else None
    pool = [generate.request(r.seed, k, tr, a, mix, dev) for k in range(tr["pool"])]
    vision = a.frontend == "vision"
    front = "no front end" if spec is None else \
        f"{p_rows} front-end rows, DR {a.frontend_dim} -> {spec.p} -> {spec.n} by {tr['dr']}"
    r.log(f"[set-up] {a.name}: {a.n_layers} layers, d_model {a.d_model}, heads "
          f"{a.n_heads}/{a.n_kv_heads}; a request {n} x ({front}; {t_tok} tokens), "
          f"{steps} decode steps")

    state = {"i": 0, "failed": 0}
    lat: List[float] = []
    kept: Dict[int, dict] = {}

    def issue():
        i = state["i"]
        state["i"] += 1
        x = pool[i % len(pool)]
        t = common.now()
        red = None
        if spec is not None:
            with torch.profiler.record_function("portbench.dr"):
                rows_in = x["rows"]
                red = svc.serve_and_update("dr", rows_in) if update else \
                    svc.transform("dr", rows_in)
            if every and (i + 1) % every == 0:
                with torch.profiler.record_function("portbench.promote"):
                    svc.promote("dr")
        if spec is None:
            batch = {"tokens": x["tokens"]}
        else:
            feats = red.reshape(n, p_rows, -1)
            batch = {"patches": feats, "tokens": x["tokens"]} if vision else {"frames": feats}
        with torch.profiler.record_function("portbench.submit"):
            ticket = sched.lm_prefill(cfg, None, params, batch, s_total + steps,
                                      max_delay_ms=0.0, execution=exe)
        return i, t, ticket, red

    def decode(logits, cache):
        """The greedy decode of every stream: ([first token, one a step],
        [each step's logits])."""
        toks, out = [logits.argmax(-1)], []
        at = (cache["len"], cache["pos"])
        for _ in range(steps):
            with torch.profiler.record_function("portbench.decode"):
                ticket = sched.lm_decode(cfg, None, params, toks[-1], cache, max_delay_ms=0.0,
                                         execution=exe)
                ticket.wait(300.0)
                lg, cache = ticket.result()
            if r.fault == "decode_unchanged":       # the step hands back the cache it was given
                cache = dict(cache, len=at[0], pos=at[1])
            out.append(lg)
            tok = lg.argmax(-1)
            if r.fault == "token_altered":          # stream 0's token changed where it is made
                tok = tok.clone()
                tok[0] = (tok[0] + 1) % a.vocab_size
            toks.append(tok)
        return toks, out

    def complete(req, record: bool):
        i, t, ticket, red = req
        with torch.profiler.record_function("portbench.wait"):
            ticket.wait(300.0)
        try:
            logits, cache = ticket.result()
            if r.fault == "answer_altered":
                logits = logits.clone()
                logits[0] = logits[0].roll(1)
            toks, dec = decode(logits, cache) if steps else (None, None)
        except Exception:  # noqa: BLE001 — a failed request is counted, not raised
            state["failed"] += record
            if record:
                lat.append(math.inf)
            return
        del cache
        with torch.profiler.record_function("portbench.readback"):
            if steps:
                answer = torch.stack(toks, dim=1).to("cpu")
            else:
                answer = logits.argmax(-1).to("cpu") if a.causal else logits.to("cpu")
        done = common.now()
        if record:
            lat.append((done - t) * 1e3)
            got = {"rows": red, "logits": logits, "decode": dec, "answer": answer}
            if _kept(r.seed, i, tr["sample_every"]):
                kept[i] = got
            state["last"] = (i, got)

    def drive(count=None, until=None, record=True):
        """Keep `in_flight` requests open until `count` have been issued or
        the clock passes `until`, then finish those open."""
        open_ = collections.deque()
        issued = 0
        while True:
            while len(open_) < tr["in_flight"] and (
                    (count is not None and issued < count)
                    or (until is not None and common.now() < until)):
                open_.append(issue())
                issued += 1
            if not open_:
                return issued
            complete(open_.popleft(), record)

    drive(count=tr["warmup"], record=False)
    common.sync(dev)
    r.log(f"[set-up] {common.now() - r.t_start:.2f} s: {tr['warmup']} warm-up requests done")
    setup_peak = common.peak_bytes(dev)
    common.reset_peak(dev)
    first = state["i"]
    prof: Dict = {}
    traced = 0
    t0 = common.now()
    if r.trace:
        with devtrace.profiled(dev, prof):
            with devtrace.slice_span():
                traced = drive(count=tr["trace_requests"])
                common.sync(dev)
    drive(until=t0 + r.seconds)
    common.sync(dev)
    window_s = common.now() - t0
    window_peak = common.peak_bytes(dev)
    done = state["i"] - first
    slo = svc.metrics()["slo"].get("lm", {}).get("prefill", {})
    live = staged = None
    if spec is not None:
        live = svc.registry.get("dr").state.stages[1].clone()
        staged = svc.staged_state("dr")
        staged = None if staged is None else staged.stages[1].clone()
    sched.shutdown()
    if "last" in state:             # the last request finished is always checked
        kept.setdefault(*state.pop("last"))
    r.log(f"[window] {done} requests in {window_s:.3f} s, {state['failed']} failed")
    layer = {}
    if r.trace:
        unit_flops = flops.prefill_flops(a, n, s_total, p_rows)
        if steps:
            unit_flops += flops.decode_flops(a, n, s_total, steps)
        dr_bound = {}
        if spec is not None:
            dr_bound = {
                "fused_transform": flops.fused_transform_bound_s(rows, a.frontend_dim, spec.p,
                                                                 spec.n),
                "ternary_matmul": flops.ternary_matmul_bound_s(rows, a.frontend_dim, spec.p),
                "easi": flops.easi_bound_s(rows, spec.n, spec.p, not spec.bypass_whitening)}
        layer = {"trace": devtrace.collect(prof), "units": traced, "unit_flops": unit_flops,
                 "flash_bound_s": flops.flash_bound_s(a, n, s_total, lse=False),
                 "dr_bound_s": dr_bound, "peak_bytes": window_peak,
                 "queue_delay_p50_ms": (slo.get("queue_delay") or {}).get("p50_ms")}
    out = {"t0": t0, "window_s": window_s, "done": done, "failed": state["failed"],
           "latencies": lat, "tokens": (done - state["failed"]) * n * (s_total + steps),
           "memory_peak_bytes": max(setup_peak, window_peak), "layer": layer,
           "kept": kept, "live": live, "staged": staged, "issued": state["i"]}
    del svc, sched, params, pool, prog, model
    common.free(dev)
    return out


def reference(r: Run, prec, issued: int, sample: List[int], fed: Dict[int, torch.Tensor]):
    """The reference's DR history over requests 0..issued-1 and its answers
    at `sample`: ({i: (rows, last logits, decoded positions' logits)}, live
    B, staged B).  A decode is teacher-forced along `fed[i]` (sequences,
    decode steps), the greedy tokens of request i's streams."""
    ref = bench.reference_of(r)
    a, tr, dev = r.arch, r.traffic, r.device
    ref.strict_f32()
    spec = a.dr_frontend
    n, p_rows, t_tok = tr["sequences"], tr["prefix_rows"], tr["text_tokens"]
    s_total = p_rows + t_tok
    params = weights.draw_params(a, r.seed, dev)
    rr = b = live = None
    if spec is not None:
        rr, b = weights.draw_dr(a, r.seed, dev)
        live = b.clone()
    mix = generate.mixing(r.seed, a.frontend_dim, dev) if p_rows else None
    pool = [generate.request(r.seed, k, tr, a, mix, dev) for k in range(tr["pool"])]
    update = tr["dr"] == "serve_and_update" and spec is not None
    every = tr["promote_every"]
    answers = {}
    todo = set(sample)
    with torch.no_grad():
        for i in range(issued):
            x = pool[i % len(pool)]
            if i in todo:
                red = feats = None
                if spec is not None:
                    red = ref.dr_transform(rr, live, x["rows"], prec.dr)
                    feats = red.reshape(n, p_rows, -1)
                if tr.get("decode_steps"):
                    toks = torch.cat([x["tokens"], fed[i].to(dev, x["tokens"].dtype)], dim=1)
                    lg = ref.stream_logits(params, a, feats, toks, s_total - 1, prec.lm)
                    answers[i] = (red, lg[:, 0], lg[:, 1:])
                else:
                    answers[i] = (red, ref.last_logits(params, a, feats, x.get("tokens"),
                                                       prec.lm), None)
            if update:
                b = ref.easi_update(rr, b, x["rows"], spec.mu, not spec.bypass_whitening, prec.dr)
                if every and (i + 1) % every == 0:
                    live = b.clone()
    staged = b if update and not (every and issued % every == 0) else None
    del params, pool
    common.free(dev)
    return answers, live, staged


def compare(got: Dict, want, b0: Optional[torch.Tensor], update: bool):
    """The numbers that decide `correct`: the widest relative gap of the
    reduced rows (with a DR unit), of a stream's last-position logits and
    (with a decode) of each decoded position's logits over the sample, and
    with train-while-serve, of the live and staged B's change.  (How far a
    served token's logit lies below the reference's best is not compared:
    the control reads it only 2.1 – 2.5 times the program, `PERF.md`.)"""
    answers, live, staged = want
    rows = logits = decoded = 0.0
    for i, (red, lg, dec) in answers.items():
        g = got["kept"][i]
        if red is not None:
            rows = max(rows, common.rel(g["rows"], red))
        for j in range(lg.shape[0]):
            logits = max(logits, common.rel(g["logits"][j], lg[j]))
        if dec is not None:
            for t, g_lg in enumerate(g["decode"]):
                for j in range(dec.shape[0]):
                    decoded = max(decoded, common.rel(g_lg[j], dec[j, t]))
    out = [("rows", rows)] if b0 is not None else []
    out.append(("logits", logits))
    if any(dec is not None for _, _, dec in answers.values()):
        out.append(("decode_logits", decoded))
    if update:
        def b_gap(pb, rb):
            if (pb is None) != (rb is None):
                return math.inf
            if pb is None:
                return 0.0
            return float(torch.linalg.vector_norm((pb - rb).double())
                         / torch.linalg.vector_norm((rb - b0).double()).clamp(min=1e-300))
        out.append(("dr_b", max(b_gap(got["live"], live), b_gap(got["staged"], staged))))
    return out


def sample_of(r: Run, kept: Dict[int, dict]) -> List[int]:
    """At most `reference_sample` of the kept requests, drawn from the seed,
    the last one among them."""
    ids = sorted(kept)
    if not ids:
        return []
    rng = np.random.default_rng(np.random.SeedSequence([r.seed & 0xFFFFFFFF, r.seed >> 32, 11]))
    k = min(len(ids), r.traffic["reference_sample"])
    pick = set(rng.choice(ids[:-1], size=k - 1, replace=False).tolist()) if k > 1 else set()
    return sorted(pick | {ids[-1]})


def greedy_tokens(kept: Dict[int, dict]) -> Dict[int, torch.Tensor]:
    """(sequences, decode steps): the tokens a greedy decode feeds after
    each kept request's prompt, the argmax of the program's own logits at
    each position before the last.  A decode that fed another token went
    on from it, so its later logits part from the reference's."""
    return {i: torch.stack([g["logits"].argmax(-1)] + [lg.argmax(-1) for lg in g["decode"][:-1]],
                           dim=1)
            for i, g in kept.items() if g["decode"] is not None}


def run(r: Run) -> Outcome:
    got = program(r)
    sample = sample_of(r, got["kept"])
    want = reference(r, bench.reference_of(r).Precision(), got["issued"], sample,
                     greedy_tokens(got["kept"]))
    b0 = weights.draw_dr(r.arch, r.seed, r.device)[1] if r.arch.dr_frontend is not None else None
    update = r.traffic["dr"] == "serve_and_update" and b0 is not None
    checks = compare(got, want, b0, update) if sample else []
    return Outcome(attempted=got["done"], failed=got["failed"], t_window=got["t0"],
                   e2e={"serve_tokens_per_s": got["tokens"] / got["window_s"],
                        "latency_p95_ms": common.percentile(got["latencies"], 95)},
                   checks=checks, memory_peak_bytes=got["memory_peak_bytes"],
                   layer=got["layer"])
