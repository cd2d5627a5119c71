"""Batched LM serving driven through the serving engine, on a mesh.

The port of `examples/serve_lm.py`, on the card by default:

    python -m repro_torch.experiments.serve_lm [--tokens 16] [--batch 4] [--device cpu]

Two request paths, ONE admission queue, one deadline scheduler:

  * DR features — ragged blocks of feature frames submitted with a 5 ms
    budget; the `DeadlineScheduler` coalesces them into power-of-two
    buckets and flushes on fill-or-deadline.  The same traffic streams
    through `model.update` (train-while-serve) and the retrained state is
    promoted live at the end, fleet-wide: the registry is replicated over
    three hosts on a `LocalBus`.
  * LM tokens — prefill a batch of prompts on `make_smoke_mesh()` (params
    laid out by `param_specs`), then decode greedily with the KV cache; the
    steps go through the SAME queue and the SAME bounded cache as the DR
    bucket programs.

The finale is a leader failover: the leader host is partitioned away, a
follower wins a higher term, the next retrained state is promoted through
the new leader, and the healed old leader rejoins as a follower.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.execution import Execution
from repro_torch.dist import sharding
from repro_torch.dr import DRModel, EASIStage, RPStage
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import api
from repro_torch.serve import (BucketPolicy, DRService, DeadlineScheduler, Elector, LocalBus,
                               ReplicatedRegistry, ReplicationError)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o_danube3_4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--frame-dim", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    exe = Execution(backend="kernel", device=args.device)
    dev = exe.torch_device()

    cfg = registry.get_smoke(args.arch)
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg, execution=exe)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    cache_size = args.prompt_len + args.tokens

    # ---- one engine, one deadline scheduler for BOTH workloads ------------
    dr = DRModel(stages=(RPStage(args.frame_dim, 16), EASIStage.rotation(16, 8, mu=5e-4)),
                 execution=exe, block_size=8)
    bus = LocalBus()
    leader = ReplicatedRegistry(bus.attach("h0"), role="leader")
    followers = [ReplicatedRegistry(bus.attach(f"h{i}"), role="follower", leader="h0")
                 for i in (1, 2)]
    svc = DRService(registry=leader, buckets=BucketPolicy(min_bucket=8, max_bucket=64))
    svc.register("frames", dr, dr.init(torch.Generator().manual_seed(2)))
    sched = DeadlineScheduler(svc, default_max_delay_ms=5.0, wake_lead_ms=1.0)

    rng = np.random.RandomState(3)
    frames = [torch.from_numpy(rng.randn(int(n), args.frame_dim).astype(np.float32)).to(dev)
              for n in rng.randint(5, 40, size=args.batch)]
    tickets = [sched.submit("frames", f) for f in frames]
    for t in tickets:
        t.wait(30.0)
    reduced = [t.result() for t in tickets]

    # train-while-serve on the same traffic, then a fleet-wide hot swap
    stream = torch.cat(frames, dim=0)
    blocks = stream[: (stream.shape[0] // 8) * 8].reshape(-1, 8, args.frame_dim)
    for blk in blocks:
        svc.serve_and_update("frames", blk)
    live_version = svc.promote("frames")
    fleet_live = {h: s["live"].get("frames") for h, s in leader.fleet_status().items()}
    assert set(fleet_live.values()) == {live_version}, fleet_live

    # LM path on the mesh, through the SAME queue and the SAME bounded cache
    mesh = make_smoke_mesh(device=args.device)
    laid = sharding.lay_out(params, sharding.param_specs(params, mesh), mesh)
    tp = sched.lm_prefill(cfg, mesh, laid, {"tokens": prompts}, cache_size,
                          max_delay_ms=2.0, execution=exe)
    tp.wait(60.0)
    logits, cache = tp.result()
    tok = sharding.full(logits).argmax(-1).to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(args.tokens - 1):
        td = sched.lm_decode(cfg, mesh, laid, tok, cache, max_delay_ms=2.0, execution=exe)
        td.wait(60.0)
        logits, cache = td.result()
        tok = sharding.full(logits).argmax(-1).to(torch.int32)
        out.append(tok)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    gen = torch.stack(out, dim=1)
    print(f"arch={cfg.name} (smoke) window={cfg.sliding_window} "
          f"cache={tuple(cache['k'].shape)} mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    for i in range(args.batch):
        print(f"req {i}: prompt={prompts[i, :8].tolist()}… -> {gen[i].tolist()} "
              f"| frames {frames[i].shape[0]}x{args.frame_dim} -> {tuple(reduced[i].shape)}")
    print(f"decode: {args.tokens - 1} steps × batch {args.batch} in {dt * 1e3:.0f} ms "
          f"({(args.tokens - 1) * args.batch / dt:.0f} tok/s, smoke config on {dev.type})")
    sched.shutdown()
    met = svc.metrics()
    print(f"engine: {met['served_rows']} rows in {met['batches_run']} micro-batches, "
          f"{met['compile_cache']['misses']} builds in ONE cache (DR buckets + LM "
          f"prefill/decode), ({met['padded_rows']} padded rows), train-while-serve "
          f"promoted v{live_version} after {met['updates_applied']['frames']} updates")
    print(f"fleet: live version per host {fleet_live} "
          f"(two-phase promote — no host serves a stale epoch)")
    print(f"deadlines: {met['deadline_met']} met / {met['deadline_missed']} missed")
    for name, cells in met["slo"].items():
        for bucket, cell in cells.items():
            e2e = cell["e2e"]
            print(f"  slo[{name}/{bucket}]: n={e2e['count']} p50={e2e['p50_ms']:.2f}ms "
                  f"p99={e2e['p99_ms']:.2f}ms queue_p50={cell['queue_delay']['p50_ms']:.2f}ms")

    # ---- leader failover: kill h0, elect a successor, keep promoting ------
    regs = [leader] + followers
    electors = [Elector(r, seed=i, election_timeout_ms=(30.0, 60.0),
                        heartbeat_interval_ms=10.0) for i, r in enumerate(regs)]
    bus.partition("h0")
    t0 = time.perf_counter()
    new_lead = None
    while new_lead is None:
        for e in electors[1:]:
            e.poll()
        new_lead = next((r for r in followers if r.role == "leader"), None)
        time.sleep(1e-3)
    other = next(r for r in followers if r is not new_lead)
    state2 = dr.update(new_lead.get("frames").state, blocks[0])
    v2 = None
    while v2 is None:
        try:
            v2 = other.promote("frames", other.push("frames", state2))
        except ReplicationError:
            time.sleep(1e-3)
    failover_ms = (time.perf_counter() - t0) * 1e3
    bus.heal()
    while leader.role == "leader":
        for e in electors:
            e.poll()
        time.sleep(1e-3)
    leader.sync()
    final = {r.transport.host_id: r.get("frames").version for r in regs}
    assert set(final.values()) == {v2}, final
    st = new_lead.leader_status()
    print(f"failover: killed h0 -> {st['leader']} leads term {st['term']} (kill -> promote "
          f"v{v2} on the new leader in {failover_ms:.0f} ms, issued on follower "
          f"{other.transport.host_id} and forwarded); healed h0 rejoined as "
          f"{leader.role!r}, fleet live={final}")
    return {"generated": gen, "reduced": reduced, "metrics": met, "final": final}


if __name__ == "__main__":
    main()
