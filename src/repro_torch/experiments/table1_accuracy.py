"""Paper Table I benchmark: Waveform-V2 classification accuracy per DR config.

The port of `benchmarks/table1_accuracy.py`: a single-seed, reduced-epoch
variant of `repro_torch.experiments.waveform_repro`, on the card unless
`execution` says otherwise.

    python -m repro_torch.experiments.table1_accuracy [--backend kernel] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

from repro_torch.configs import waveform_paper as wp
from repro_torch.core import pipeline
from repro_torch.core.execution import Execution
from repro_torch.data import waveform


def run(fast: bool = True, execution: Optional[Execution] = None):
    (xtr, ytr), (xte, yte) = waveform.paper_split(seed=0)
    rows = []
    for name, cfg in wp.TABLE1_ROWS.items():
        c = dataclasses.replace(cfg, seed=0)
        if fast:
            c = dataclasses.replace(c, dr_epochs=max(1, c.dr_epochs // 4), head_epochs=15)
        t0 = time.perf_counter()
        model = pipeline.fit_two_stage(c, xtr, ytr, execution=execution)
        acc = pipeline.evaluate(model, xte, yte, execution=execution)
        dt = time.perf_counter() - t0
        rows.append((f"table1/{name}", dt * 1e6, f"acc={acc*100:.1f}%;paper={wp.PAPER_TABLE1[name]}"))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("torch", "kernel"), default="torch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in run(execution=Execution(backend=args.backend, device=args.device)):
        print(*row, sep="\t")


if __name__ == "__main__":
    main()
