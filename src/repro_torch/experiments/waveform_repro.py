"""Reproduce the paper's Table I (Waveform-V2 accuracy) + references.

The port of `examples/waveform_repro.py`, on the card by default:

    python -m repro_torch.experiments.waveform_repro \
        [--seeds 3] [--fast] [--skip-ablations] [--backend torch|kernel] [--device cuda]

Table rows are `repro_torch.dr.DRModel` stage compositions
(`repro_torch.configs.waveform_paper`); `--backend kernel` reruns the whole
protocol through the CUDA kernels via the Execution policy — the same
protocol, another datapath.  Prints the measured accuracy next to the
paper's reported number for each row, plus init-sensitivity ablations, a
3-stage cascade and the ideal-PCA reference the paper doesn't report.
Initial states and shuffles are the port's own draws
(`pipeline.generators`), not the reference's, so single numbers differ
from the JAX package's within the spread over seeds.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import waveform_paper as wp
from repro_torch.core import pipeline
from repro_torch.core.execution import TORCH, Execution
from repro_torch.data import waveform


def run_row(name: str, cfg, seeds, xtr, ytr, xte, yte, fast=False, execution=None):
    accs = []
    for seed in seeds:
        c = dataclasses.replace(cfg, seed=seed)
        if fast:
            c = dataclasses.replace(
                c, dr_epochs=max(1, c.dr_epochs // 4), head_epochs=15)
        model = pipeline.fit_two_stage(c, xtr, ytr, execution=execution)
        accs.append(pipeline.evaluate(model, xte, yte, execution=execution))
    return float(np.mean(accs)) * 100, float(np.std(accs)) * 100


def ideal_pca_reference(xtr, ytr, xte, yte, n, seed=0, execution=None):
    """Closed-form PCA whitening to n dims — the information ceiling."""
    from repro_torch.models import mlp

    dev = (execution if execution is not None else TORCH).torch_device()
    xtr, xte = (torch.as_tensor(x, dtype=torch.float32).to(dev) for x in (xtr, xte))
    ytr, yte = (torch.as_tensor(y).to(dev, torch.int64) for y in (ytr, yte))
    x_dr, st = pipeline.center_global_scale(xtr)
    xte_dr, _ = pipeline.center_global_scale(xte, st)
    cov = (x_dr.T @ x_dr / x_dr.shape[0]).cpu().numpy()
    evals, evecs = np.linalg.eigh(cov)
    order = np.argsort(evals)[::-1][:n]
    w = torch.from_numpy((evecs[:, order] / np.sqrt(evals[order])).T.astype(np.float32)).to(dev)
    f_tr, f_te = x_dr @ w.T, xte_dr @ w.T
    f_tr_s, stats = pipeline.standardize(f_tr)
    f_te_s, _ = pipeline.standardize(f_te, stats)
    g_init, g_shuf = pipeline.generators(seed)[1:]
    params = mlp.init(g_init, n, (64, 64), 3, device=dev)
    params = mlp.fit(params, f_tr_s, ytr, generator=g_shuf)
    return mlp.accuracy(params, f_te_s, yte) * 100


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--fast", action="store_true", help="reduced epochs (CI smoke)")
    ap.add_argument("--skip-ablations", action="store_true")
    ap.add_argument("--backend", choices=("torch", "kernel"), default="torch",
                    help="execution backend for every DR stage")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    execution = Execution(backend=args.backend, device=args.device)

    (xtr, ytr), (xte, yte) = waveform.paper_split(seed=0)
    seeds = list(range(args.seeds))

    print(f"Waveform-V2: train {xtr.shape} test {xte.shape} (paper protocol, "
          f"backend={args.backend}, device={args.device})")
    print(f"{'row':26s} {'ours (mean±std %)':>20s} {'paper %':>8s}")
    rows = {}
    for name, cfg in wp.TABLE1_ROWS.items():
        mean, std = run_row(name, cfg, seeds, xtr, ytr, xte, yte, fast=args.fast,
                            execution=execution)
        rows[name] = mean
        print(f"{name:26s} {mean:13.1f} ± {std:4.1f} {wp.PAPER_TABLE1[name]:8.1f}")

    # The paper's core claim, init-matched: RP+EASI ≈ EASI at equal n.
    d16 = rows["rp24_easi_n16"] - rows["easi_n16"]
    d8 = rows["rp16_easi_n8"] - rows["easi_n8"]
    print(f"\nclaim check (init-matched): Δ(n=16) = {d16:+.1f}  Δ(n=8) = {d8:+.1f}  "
          f"(paper: −0.1 / −0.1)")

    if not args.skip_ablations:
        print("\nablations / references:")
        for name, cfg in {**wp.ABLATION_ROWS, **wp.CASCADE_ROWS}.items():
            mean, std = run_row(name, cfg, seeds[:1], xtr, ytr, xte, yte, fast=args.fast,
                                execution=execution)
            print(f"{name:26s} {mean:13.1f} ± {std:4.1f}      n/a")
        for n in (16, 8, 4):
            acc = ideal_pca_reference(xtr, ytr, xte, yte, n, execution=execution)
            print(f"{'ideal_pca_n%d' % n:26s} {acc:13.1f}          n/a")
    return rows


if __name__ == "__main__":
    main()
