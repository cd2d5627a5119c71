"""The training driver: a closed loop of the port's train step
(`train.train_step.make_train_step`, kernel backend, remat, AdamW, the DR
front end co-trained by EASI in every step).

Set-up draws the weights and the DR unit from the seed, builds the one
train state and step, and drives them through their first `checked_steps`
steps on batches that all differ, through the same call and feed as the
window; those steps also warm up every shape (a configuration with no DR
unit trains without one).  The window then runs steps
back to back, reading the loss to the host every `log_every` steps as a
trainer logs it, and ends at a synchronise after the last step.  Once it
has closed and the program's state is freed, the reference follows the
first steps from the same weights and batches, and the run compares each
step's loss, the first gradient as AdamW got it (its first moment over
1 − b1), the parameters' change over the checked steps, and the DR unit's
B after them.  The reference is the module the configuration's
`reference` key names.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional

import torch

from portbench import arch as arch_mod
from portbench import bench, common, devtrace, flops, generate, weights
from portbench.bench import Outcome, Run

DR_UPDATE_ROWS = 4096    # the rows of a batch the step folds into the DR unit


def _flat(tree, prefix="") -> Dict[str, torch.Tensor]:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _norms(tree: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, torch.Tensor]:
    return {p: torch.linalg.vector_norm(t.float()) * scale for p, t in tree.items()}


def _change(a, seed: int, params: Dict[str, torch.Tensor], device) -> Dict[str, float]:
    """‖p − p₀‖ by leaf, p₀ drawn again from the seed one leaf at a time."""
    out = {}
    for spec in weights.leaf_specs(a):
        p0 = weights.draw_leaf(seed, spec, device)
        out[spec[0]] = float(torch.linalg.vector_norm(params[spec[0]].float() - p0))
        del p0
    return out


def program(r: Run):
    """The program's run: set-up, checked steps, window.  Returns (readings
    of the checked steps, the window's numbers)."""
    from repro_torch.core import dr_unit
    from repro_torch.core.execution import Execution
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts

    a, tr, dev = r.arch, r.traffic, r.device
    cfg = arch_mod.port_config(a)
    exe = Execution(backend="kernel", device=dev.type)
    tcfg = ts.TrainConfig(arch=cfg)
    params = weights.draw_params(a, r.seed, dev)
    spec = a.dr_frontend
    zero = torch.zeros((), dtype=torch.int32)
    dr = None
    if spec is not None:
        rr, b0 = weights.draw_dr(a, r.seed, dev)
        dr = dr_unit.DRState(r=rr, b=b0.clone(), steps=zero.clone())
    state = ts.TrainState(params=params, opt=opt_mod.init(params), dr=dr, step=zero.clone())
    del params
    step = ts.make_train_step(tcfg, execution=exe)
    if r.fault == "unchanged":
        inner = step

        def step(state, batch):
            return state, inner(state, batch)[1]
    elif r.fault == "half_batch":
        inner = step

        def step(state, batch):
            return inner(state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})

    mix = generate.mixing(r.seed, a.frontend_dim, dev) if a.frontend is not None else None
    pool = [generate.train_batch(r.seed, k, tr, a, mix, dev) for k in range(tr["pool"])]
    common.sync(dev)
    r.log(f"[set-up] {common.now() - r.t_start:.2f} s: weights, DR unit, AdamW state and "
          f"{len(pool)} batches on the device")
    front = "no DR unit" if spec is None else \
        f"DR {a.frontend_dim} -> {spec.p} -> {spec.n}"
    r.log(f"[set-up] {a.name}: {a.n_layers} layers, d_model {a.d_model}, heads "
          f"{a.n_heads}/{a.n_kv_heads}, batch {tr['batch']} x {tr['seq']}, {front}; no tile "
          f"race on this path (the serving engine races tiles; training runs the Execution's "
          f"own)")
    checked = tr["checked_steps"]
    losses, g1 = [], None
    for k in range(checked):
        state, met = step(state, pool[k])
        losses.append(met["loss"])
        if k == 0:
            g1 = _norms(_flat(state.opt.m), 1.0 / (1.0 - tcfg.opt.b1))
    readings = {"loss": [float(x) for x in losses], "g1": {p: float(v) for p, v in g1.items()},
                "change": _change(a, r.seed, _flat(state.params), dev),
                "b": None if spec is None else state.dr.b.detach().clone()}
    del met, losses, g1
    common.sync(dev)
    r.log(f"[set-up] {common.now() - r.t_start:.2f} s: {checked} checked steps done")
    setup_peak = common.peak_bytes(dev)
    common.reset_peak(dev)

    n_pool, log_every = len(pool), tr["log_every"]
    prof: Dict = {}
    traced = 0
    t0 = common.now()
    i = 0
    if r.trace:
        with devtrace.profiled(dev, prof):
            with devtrace.slice_span():
                for _ in range(tr["trace_steps"]):
                    with torch.profiler.record_function("portbench.step"):
                        state, met = step(state, pool[(checked + i) % n_pool])
                    i += 1
                common.sync(dev)
        traced = i
    while True:
        state, met = step(state, pool[(checked + i) % n_pool])
        i += 1
        if i % log_every == 0:
            float(met["loss"])
        if common.now() - t0 >= r.seconds:
            break
    common.sync(dev)
    window_s = common.now() - t0
    window_peak = common.peak_bytes(dev)
    tokens = i * tr["batch"] * tr["seq"]
    r.log(f"[window] {i} steps in {window_s:.3f} s; last loss {float(met['loss']):.6f}")
    layer = {}
    if r.trace:
        b, s = tr["batch"], tr["seq"]
        rows = b * s
        upd = min(rows, DR_UPDATE_ROWS)         # the update reads the first rows only
        dr_bound = {}
        if spec is not None:
            dr_bound = {
                "fused_transform": flops.fused_transform_bound_s(rows, a.frontend_dim, spec.p,
                                                                 spec.n),
                "ternary_matmul": flops.ternary_matmul_bound_s(upd, a.frontend_dim, spec.p),
                "easi": flops.easi_bound_s(upd, spec.n, spec.p, not spec.bypass_whitening)}
        layer = {"trace": devtrace.collect(prof), "units": traced,
                 "unit_flops": flops.train_flops(a, b, s),
                 "flash_bound_s": flops.flash_bound_s(a, b, s, lse=True),
                 "dr_bound_s": dr_bound, "peak_bytes": window_peak}
    del state, step, pool, met
    common.free(dev)
    window = {"t0": t0, "steps": i, "window_s": window_s, "tokens": tokens,
              "memory_peak_bytes": max(setup_peak, window_peak), "layer": layer}
    return readings, window


def reference(r: Run, prec) -> Dict:
    """The reference's readings of the checked steps at precision `prec`."""
    ref = bench.reference_of(r)
    a, tr, dev = r.arch, r.traffic, r.device
    ref.strict_f32()
    params = weights.draw_params(a, r.seed, dev)
    for t in ref.leaves(params).values():
        t.requires_grad_(True)
    rr = b = None
    if a.dr_frontend is not None:
        rr, b = weights.draw_dr(a, r.seed, dev)
    mix = generate.mixing(r.seed, a.frontend_dim, dev) if a.frontend is not None else None
    opt = {"t": 0, "m": {}, "v": {}}
    losses, g1 = [], None
    for k in range(tr["checked_steps"]):
        batch = generate.train_batch(r.seed, k, tr, a, mix, dev)
        loss, gnorms, b = ref.train_step(params, opt, (rr, b), batch, a, prec)
        losses.append(float(loss))
        g1 = gnorms if k == 0 else g1
    with torch.no_grad():
        change = _change(a, r.seed, {p: t.detach() for p, t in ref.leaves(params).items()}, dev)
    out = {"loss": losses, "g1": g1, "change": change,
           "b": None if b is None else b.detach().clone()}
    del params, opt
    common.free(dev)
    return out


def compare(got: Dict, want: Dict, b0: Optional[torch.Tensor]):
    """The numbers that decide `correct`, with the leaves the change skips
    (B's change only with a DR unit)."""
    loss = max(abs(x - y) / abs(y) for x, y in zip(got["loss"], want["loss"]))
    med = statistics.median(want["g1"].values())
    # a leaf whose reference gradient is nought to rounding (the audio
    # model's unread token embedding) moves under AdamW by round-off alone
    keep = [p for p, v in want["g1"].items() if v >= 1e-3 * med]
    out = [("loss", loss),
           ("grad_norm", common.worst_leaf(got["g1"], want["g1"])),
           ("update_norm", common.worst_leaf(got["change"], want["change"], keep))]
    if b0 is not None:
        out.append(("dr_b", float(torch.linalg.vector_norm((got["b"] - want["b"]).double())
                                  / torch.linalg.vector_norm((want["b"] - b0).double()))))
    return out


def run(r: Run) -> Outcome:
    readings, w = program(r)
    want = reference(r, bench.reference_of(r).Precision())
    b0 = weights.draw_dr(r.arch, r.seed, r.device)[1] if r.arch.dr_frontend is not None else None
    checks = compare(readings, want, b0)
    return Outcome(attempted=w["steps"], failed=0, t_window=w["t0"],
                   e2e={"train_tokens_per_s": w["tokens"] / w["window_s"]},
                   checks=checks, memory_peak_bytes=w["memory_peak_bytes"], layer=w["layer"])
