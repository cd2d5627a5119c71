#!/usr/bin/env python3
"""Drive the PyTorch port of the DR datapath on one CUDA card.

    python3 chip_smoke.py

Phases (the first that fails ends the run with a non-zero exit code):

  1. card     — the card's name and power limit, torch / CUDA versions, and
                the build of every CUDA kernel from `src/repro_torch/kernels/csrc`
  2. kernels  — each kernel against its plain PyTorch version on the card,
                at the reference tests' shapes (ragged odd sizes included),
                in f32 and bf16, plus integer exactness
  3. paper    — the paper's model rp24_easi_n16 (RP 32→24, rotation EASI
                24→16, block 32) on Waveform-V2: init → fit (4000 rows, 40
                epochs) → transform (1000 rows) → train-while-serve over
                ragged requests, through the kernels; the same sequence on
                the plain torch backend is the reference
  4. wide     — the repo's wide DR row (1024 → 256 → 128, block 256):
                update + transform through the kernels, then each kernel
                timed beside its plain version, a cuBLAS yardstick and its
                bound

It prints a `{"kernels": [...]}` JSON line, the card's line from nvidia-smi,
and as its last line `{"ok": true, "device": {...}}`.  It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores and HBM rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
EASI_TOL = dict(rtol=2e-5, atol=2e-6)          # tests/test_kernels.py:107
TRAJ_TOL = dict(rtol=5e-4, atol=5e-5)          # tests/test_kernels.py:162
OUT_TOL = dict(rtol=1e-4, atol=1e-4)           # tests/test_fused_transform.py:174

TMM_SHAPES = [(1, 32, 24), (8, 32, 16), (37, 100, 9), (128, 256, 128), (256, 555, 77),
              (64, 1024, 256), (40, 300, 48)]
FUSED_SHAPES = [(8, 32, 16, 8), (13, 32, 16, 8), (64, 33, 17, 9), (200, 100, 40, 10),
                (5, 7, 3, 2), (1, 32, 16, 8), (40, 300, 48, 12)]
EASI_SHAPES = [(1, 8, 32), (32, 16, 32), (8, 24, 24), (64, 7, 100), (128, 128, 512),
               (16, 100, 300)]
SO_HO = [(True, True), (True, False), (False, True)]

WIDE = dict(m=1024, p=256, n=128, block=256)    # benchmarks/throughput.py:41
PAPER = dict(m=32, p=24, n=16, block=32, mu=2e-4, epochs=40)  # configs/waveform_paper.py


class SmokeFailure(Exception):
    pass


def fail(msg: str) -> None:
    raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def max_err(got, want) -> float:
    import torch

    return float((got.to(torch.float32) - want.to(torch.float32)).abs().max()) \
        if got.numel() else 0.0


def check_close(what: str, got, want, *, rtol: float, atol: float) -> float:
    """assert_allclose semantics on the card; returns the largest |got − want|."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: got {tuple(got.shape)} {got.dtype}, want {tuple(want.shape)} {want.dtype}")
    g, w = got.to(torch.float32), want.to(torch.float32)
    if not bool(torch.isfinite(g).all()):
        fail(f"{what}: non-finite values")
    bad = (g - w).abs() > atol + rtol * w.abs()
    if bool(bad.any()):
        fail(f"{what}: {int(bad.sum())} of {g.numel()} elements outside rtol={rtol} "
             f"atol={atol}; max |err| {max_err(g, w):.3e}")
    return max_err(g, w)


def time_events(fn, iters: int = 200, warmup: int = 20) -> float:
    """ms per call of back-to-back calls, CUDA events around the loop."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph(fn, iters: int = 100, replays: int = 10) -> float:
    """ms per call on the device alone: `iters` calls captured in one CUDA
    graph, replayed `replays` times between CUDA events (no host launch cost)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phase 1: card, versions, build
# ---------------------------------------------------------------------------

def phase_card():
    import torch
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    print(f"[card] {card_line}")
    print(f"[card] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    _build.library(verbose=True)
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc: {_build.nvcc_path()})")
    return card_line


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

def phase_kernels(dev, errs):
    import torch
    from repro_torch.core import random_projection as rp
    from repro_torch.kernels import easi_update, fused_transform, ternary_matmul

    gen = torch.Generator().manual_seed(1234)

    def normal(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dtype).to(dev)

    def ternary(p, m):
        return rp.sample_ternary(gen, rp.RPConfig(m=m, p=p)).to(dev)

    def note(name, dtype, err):
        key = (name, "f32" if dtype == torch.float32 else "bf16")
        errs[key] = max(errs.get(key, 0.0), err)

    n_checks = 0
    tmm = ternary_matmul.ternary_matmul
    for (b, m, p) in TMM_SHAPES + [(WIDE["block"], WIDE["m"], WIDE["p"]), (4000, 32, 24)]:
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            x, r = normal(b, m, dtype=dtype), ternary(p, m)
            got = tmm(x, r, scale=0.37)
            want = ternary_matmul.plain(x, r, scale=0.37)
            note("ternary_matmul", dtype, check_close(
                f"ternary_matmul b={b} m={m} p={p} {dtype}", got, want, **tol))
            n_checks += 1
    xi = torch.randint(-8, 8, (16, 64), generator=gen).to(torch.float32).to(dev)
    ri = ternary(32, 64)
    if not torch.equal(tmm(xi, ri), ternary_matmul.plain(xi, ri)):
        fail("ternary_matmul: integer inputs are not exact")
    n_checks += 1

    ft = fused_transform.fused_transform
    for (rows, m, p, n) in FUSED_SHAPES + [(WIDE["block"], WIDE["m"], WIDE["p"], WIDE["n"]),
                                           (1000, 32, 24, 16)]:
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            x, r, bm = normal(rows, m, dtype=dtype), ternary(p, m), normal(n, p, dtype=dtype)
            got = ft(x, r, bm, scale=0.37)
            want = fused_transform.plain(x, r, bm, scale=0.37)
            note("fused_transform", dtype, check_close(
                f"fused_transform rows={rows} m={m} p={p} n={n} {dtype}", got, want, **tol))
            n_checks += 1
    xi = torch.randint(-8, 8, (16, 64), generator=gen).to(torch.float32).to(dev)
    bi = torch.randint(-4, 4, (8, 32), generator=gen).to(torch.float32).to(dev)
    if not torch.equal(ft(xi, ri, bi), fused_transform.plain(xi, ri, bi)):
        fail("fused_transform: integer inputs are not exact")
    n_checks += 1

    ea = easi_update.easi_apply
    cases = [(b, n, m, so, ho, "cubic", 1e-3, 0.3) for (b, n, m) in EASI_SHAPES
             for (so, ho) in SO_HO]
    cases += [(32, 16, 48, True, True, g, 5e-4, 0.2) for g in ("cubic", "tanh", "sign_cubic")]
    cases += [(WIDE["block"], WIDE["n"], WIDE["p"], False, True, "cubic", 2e-4, 0.3),
              (PAPER["block"], PAPER["n"], PAPER["p"], False, True, "cubic", 2e-4, 0.3)]
    for (b, n, m, so, ho, g, mu, s) in cases:
        bm, y = normal(n, m, scale=s), normal(b, n)
        kw = dict(mu=mu, second_order=so, higher_order=ho, g_name=g)
        note("easi_apply", torch.float32, check_close(
            f"easi_apply b={b} n={n} m={m} so={so} ho={ho} g={g}",
            ea(bm, y, **kw), easi_update.plain(bm, y, **kw), **EASI_TOL))
        n_checks += 1
    # sign_cubic at y = 0 must contribute 0, as jnp.sign does
    y0 = normal(8, 16)
    y0[:, :4] = 0.0
    bm = normal(16, 40, scale=0.2)
    kw = dict(mu=1e-3, g_name="sign_cubic")
    check_close("easi_apply sign_cubic with zeros", ea(bm, y0, **kw),
                easi_update.plain(bm, y0, **kw), **EASI_TOL)
    bm, y = normal(16, 48, dtype=torch.bfloat16, scale=0.2), normal(32, 16, dtype=torch.bfloat16)
    note("easi_apply", torch.bfloat16, check_close(
        "easi_apply bf16", ea(bm, y, mu=5e-4), easi_update.plain(bm, y, mu=5e-4), **BF16_TOL))
    n_checks += 2
    torch.cuda.synchronize()
    print(f"[kernels] {n_checks} checks against the plain versions passed; largest |err|: "
          + ", ".join(f"{k[0]}/{k[1]} {v:.3e}" for k, v in sorted(errs.items())))


# ---------------------------------------------------------------------------
# phase 3: the paper's model, trained and served through the kernels
# ---------------------------------------------------------------------------

def reset_counts():
    from repro_torch.kernels import easi_update, fused_transform, ternary_matmul

    for mod in (ternary_matmul, fused_transform, easi_update):
        mod.launches = 0


def read_counts():
    from repro_torch.kernels import easi_update, fused_transform, ternary_matmul

    return {"ternary_matmul": ternary_matmul.launches,
            "fused_transform": fused_transform.launches,
            "easi_apply": easi_update.launches}


def phase_paper(dev):
    import numpy as np
    import torch
    from repro_torch.core.easi import whiteness_kl
    from repro_torch.data import waveform
    from repro_torch.dr import DRModel, EASIStage, Execution, RPStage

    (xtr, _), (xte, _) = waveform.paper_split(seed=0)
    xtr, xte = torch.from_numpy(xtr).to(dev), torch.from_numpy(xte).to(dev)
    # centre + one global scalar scale, fitted on the training rows
    mean = xtr.mean(0)
    scale = torch.sqrt(torch.mean(torch.var(xtr - mean, dim=0, correction=0))) + 1e-8
    xtr, xte = (xtr - mean) / scale, (xte - mean) / scale

    rng = np.random.RandomState(0)
    sizes = np.clip(np.rint(rng.lognormal(mean=1.6, sigma=0.9, size=8)), 1, 48).astype(int)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    requests = [xte[s:s + k] for s, k in zip(starts, sizes)]

    def run(backend):
        model = DRModel(stages=(RPStage(PAPER["m"], PAPER["p"]),
                                EASIStage.rotation(PAPER["p"], PAPER["n"], mu=PAPER["mu"])),
                        execution=Execution(backend=backend, device=dev),
                        block_size=PAPER["block"])
        marks = [read_counts()]              # counts after each entry point
        t0 = time.perf_counter()
        state = model.init(torch.Generator().manual_seed(0))
        state = model.fit(state, xtr, epochs=PAPER["epochs"])
        marks.append(read_counts())
        y_test = model.transform(state, xte)
        marks.append(read_counts())
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        live, staged, served = state, state, []
        for xr in requests:                  # train-while-serve
            served.append(model.transform(live, xr))
            staged = model.update(staged, xr)
        marks.append(read_counts())
        live = staged                        # promote
        probe = model.transform(live, xte[:64])
        torch.cuda.synchronize()
        marks.append(read_counts())
        steps = {what: {k: after[k] - before[k] for k in after}
                 for what, before, after in zip(
                     ("fit", "transform", "serve", "transform_after_promote"),
                     marks, marks[1:])}
        return dict(model=model, state=state, y_test=y_test, served=torch.cat(served),
                    staged=staged, probe=probe, t_fit=t_fit, launches_by_entry=steps)

    reset_counts()
    k = run("kernel")
    counts = read_counts()
    t = run("torch")
    steps = PAPER["epochs"] * (4000 // PAPER["block"]) + len(requests)
    if int(k["staged"].steps) != steps:
        fail(f"paper: steps {int(k['staged'].steps)}, want {steps}")
    if tuple(k["y_test"].shape) != (1000, PAPER["n"]):
        fail(f"paper: transform shape {tuple(k['y_test'].shape)}")
    check_close("paper R", k["state"].r, t["state"].r, rtol=0, atol=0)
    err_b = check_close("paper B after fit", k["state"].b, t["state"].b, **TRAJ_TOL)
    err_y = check_close("paper transform", k["y_test"], t["y_test"], **OUT_TOL)
    check_close("paper served", k["served"], t["served"], **OUT_TOL)
    check_close("paper B after serving", k["staged"].b, t["staged"].b, **TRAJ_TOL)
    check_close("paper probe after promote", k["probe"], t["probe"], **OUT_TOL)
    kl_k, kl_t = float(whiteness_kl(k["y_test"])), float(whiteness_kl(t["y_test"]))
    if not (math.isfinite(kl_k) and abs(kl_k - kl_t) <= 1e-3 * max(1.0, abs(kl_t))):
        fail(f"paper: whiteness_kl kernel {kl_k} vs torch {kl_t}")
    print(f"[paper] rp24_easi_n16: fit {PAPER['epochs']} epochs + transform of 1000 rows in "
          f"{k['t_fit']:.2f} s (kernel) / {t['t_fit']:.2f} s (torch); "
          f"served {len(requests)} requests of {sizes.tolist()} rows")
    print(f"[paper] max |B_kernel - B_torch| {err_b:.3e}, max |y_kernel - y_torch| {err_y:.3e}, "
          f"whiteness_kl {kl_k:.6f} (torch {kl_t:.6f})")
    print(f"[paper] launches on the main path: {json.dumps(counts)}; by entry point (fit of "
          f"4000 rows x {PAPER['epochs']} epochs, transform of 1000 rows, {len(requests)} x "
          f"(transform + update), transform after promote): "
          f"{json.dumps(k['launches_by_entry'])}")
    missing = [name for name, c in counts.items() if c <= 0]
    if missing:
        fail(f"paper: kernels never launched on the main path: {missing}")
    return counts, paper_timings(k["model"], k["state"], xtr[:PAPER["block"]], xte)


def paper_timings(model, state, blk, xte):
    """Host-paced (CUDA events around back-to-back calls) and device-only
    (CUDA graph replay) times of the paper model's steps and of each kernel
    at the shapes those steps give it."""
    import torch
    from repro_torch.kernels import easi_update, fused_transform, ternary_matmul

    r, b_mat = state.r, state.b
    scale = model.stages[0].rp_cfg(model.execution).scale
    mu = model.stages[1].mu
    y = ternary_matmul.ternary_matmul(blk, r, scale=scale) @ b_mat.T
    cases = {
        "update": (lambda: model.update(state, blk), [PAPER["block"], PAPER["m"]]),
        "transform": (lambda: model.transform(state, blk), [PAPER["block"], PAPER["m"]]),
        "transform_1000": (lambda: model.transform(state, xte), [1000, PAPER["m"]]),
        "ternary_matmul": (lambda: ternary_matmul.ternary_matmul(blk, r, scale=scale),
                           [PAPER["block"], PAPER["m"], PAPER["p"]]),
        "fused_transform": (lambda: fused_transform.fused_transform(blk, r, b_mat, scale=scale),
                            [PAPER["block"], PAPER["m"], PAPER["p"], PAPER["n"]]),
        "easi_apply": (lambda: easi_update.easi_apply(b_mat, y, mu=mu, second_order=False),
                       [PAPER["block"], PAPER["n"], PAPER["p"]]),
    }
    out = {}
    for name, (fn, shape) in cases.items():
        out[name] = {"shape": shape, "ms": time_events(fn), "device_ms": time_graph(fn)}
        print(f"[paper-time] {name} {shape}: {out[name]['ms']:.4f} ms host-paced, "
              f"{out[name]['device_ms']:.4f} ms on the device alone")
    return out


# ---------------------------------------------------------------------------
# phase 4: the wide configuration, then timings
# ---------------------------------------------------------------------------

def phase_wide(dev, errs):
    import torch
    from repro_torch.kernels import easi_update, fused_transform, ternary_matmul
    from repro_torch.dr import DRModel, EASIStage, Execution, RPStage

    m, p, n, blk = WIDE["m"], WIDE["p"], WIDE["n"], WIDE["block"]
    gen = torch.Generator().manual_seed(7)
    blocks = [torch.randn((blk, m), generator=gen).to(dev) for _ in range(8)]

    def run(backend):
        model = DRModel(stages=(RPStage(m, p), EASIStage.rotation(p, n, mu=2e-4)),
                        execution=Execution(backend=backend, device=dev), block_size=blk)
        state = model.init(torch.Generator().manual_seed(0))
        outs = []
        for xb in blocks:
            outs.append(model.transform(state, xb))
            state = model.update(state, xb)
        torch.cuda.synchronize()
        return model, state, torch.cat(outs)

    reset_counts()
    model, st_k, y_k = run("kernel")
    counts = read_counts()
    _, st_t, y_t = run("torch")
    check_close("wide B after updates", st_k.b, st_t.b, **TRAJ_TOL)
    check_close("wide transform", y_k, y_t, **OUT_TOL)
    print(f"[wide] 1024→256→128, block {blk}: {len(blocks)} update + transform steps agree "
          f"with the torch backend; launches {json.dumps(counts)}")
    missing = [name for name, c in counts.items() if c <= 0]
    if missing:
        fail(f"wide: kernels never launched: {missing}")

    # ---- timings at the shapes this path gives each kernel ----------------
    x, r, b_mat = blocks[0], st_k.r, st_k.b
    scale = model.stages[0].rp_cfg(model.execution).scale
    h = ternary_matmul.ternary_matmul(x, r, scale=scale)
    y = h @ b_mat.T
    mu = model.stages[1].mu
    nnz = int((r != 0).sum())
    w = (r.to(torch.float32) * scale).T.contiguous()      # (m, p) for the yardstick
    bt = b_mat.T.contiguous()

    def lib_easi():
        hh = torch.mm((y * y * y).T, y)
        g = (hh - hh.T) / blk
        return torch.addmm(b_mat, g, b_mat, alpha=-mu)

    rows = []
    specs = [
        ("ternary_matmul", ternary_matmul, "src/repro/kernels/ternary_matmul.py:47",
         lambda: ternary_matmul.ternary_matmul(x, r, scale=scale),
         lambda: ternary_matmul.plain(x, r, scale=scale),
         lambda: torch.mm(x, w), "torch.mm(x, (scale*R)^T) on a float R made beforehand",
         2.0 * blk * nnz, 4 * blk * m + p * m + 4 * blk * p, (blk, m, p)),
        ("fused_transform", fused_transform, "src/repro/kernels/fused_transform.py:72",
         lambda: fused_transform.fused_transform(x, r, b_mat, scale=scale),
         lambda: fused_transform.plain(x, r, b_mat, scale=scale),
         lambda: torch.linalg.multi_dot([x, w, bt]),
         "torch.linalg.multi_dot([x, (scale*R)^T, B^T]) on a float R made beforehand",
         2.0 * blk * nnz + 2.0 * blk * p * n, 4 * blk * m + p * m + 4 * n * p + 4 * blk * n,
         (blk, m, p, n)),
        ("easi_apply", easi_update, "src/repro/kernels/easi_update.py:72",
         lambda: easi_update.easi_apply(b_mat, y, mu=mu, second_order=False),
         lambda: easi_update.plain(b_mat, y, mu=mu, second_order=False),
         lib_easi, "torch.mm(g(Y)^T, Y), (H - H^T)/b, torch.addmm(B, G, B, alpha=-mu)",
         2.0 * blk * n * n + 2.0 * n * n * p + 3.0 * blk * n, 4 * blk * n + 2 * 4 * n * p,
         (blk, n, p)),
    ]
    for (name, mod, replaces, kern, plain, lib, lib_what, flops, nbytes, shape) in specs:
        err = check_close(f"{name} at the wide shape", kern(), plain(),
                          **(EASI_TOL if name == "easi_apply" else F32_TOL))
        ms, plain_ms, lib_ms = time_events(kern), time_events(plain), time_events(lib)
        dev_ms, plain_dev_ms, lib_dev_ms = time_graph(kern), time_graph(plain), time_graph(lib)
        ms2 = time_events(kern)                      # kernel, plain, ..., kernel again
        bms, bby = bound_ms(flops, nbytes)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{Path(mod.__file__).stem}.cu",
            "replaces": replaces,
            "launches": None, "launches_wide": counts[name],
            "max_abs_err": err,
            "max_abs_err_sweep_f32": errs.get((name, "f32")),
            "max_abs_err_sweep_bf16": errs.get((name, "bf16")),
            "ms": ms, "ms_repeat": ms2, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": bby, "library_ms": lib_ms,
            "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
            "library_device_ms": lib_dev_ms, "library": lib_what,
            "shape": list(shape), "flops": flops, "bytes": nbytes,
        })
        print(f"[time] {name} {shape}: kernel {ms:.4f} ms ({ms2:.4f} again), device-only "
              f"{dev_ms:.4f} ms; plain {plain_ms:.4f} ms (device {plain_dev_ms:.4f}); "
              f"library {lib_ms:.4f} ms (device {lib_dev_ms:.4f}); bound {bms:.6f} ms "
              f"({bby})")
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port's package is missing under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 tolerances do not survive TF32
    torch.set_float32_matmul_precision("highest")
    t_start = time.perf_counter()
    errs = {}
    try:
        card_line = phase_card()
        phase_kernels(dev, errs)
        counts, paper_times = phase_paper(dev)
        rows = phase_wide(dev, errs)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    for row in rows:
        row["launches"] = counts[row["name"]]
        row["paper"] = paper_times[row["name"]]
    print(f"[paper-steps] {json.dumps({k: paper_times[k] for k in ('update', 'transform', 'transform_1000')})}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
