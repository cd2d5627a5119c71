"""ICA recovery quality: Amari distance vs block size / estimator variant.

The port of `benchmarks/ica_quality.py`: quantifies the claim that the
block-averaged EASI estimator (block ≥ 8) matches per-sample (paper-exact)
separation quality, on a 6-source sub-Gaussian mixture
(`repro_torch.data.mixtures`, the same arrays as the reference's for the
same seed).  Runs on the card unless `execution` says otherwise; the kernel
backend runs every update through the `easi_apply` kernel.

    python -m repro_torch.experiments.ica_quality [--backend kernel] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import easi
from repro_torch.core.execution import TORCH, Execution
from repro_torch.data import mixtures

# (block size, epochs at full size); the fast run takes max(2, epochs // 2)
BLOCKS = ((1, 2), (8, 6), (32, 16), (256, 64))
CFG = easi.EASIConfig(m=6, n=6, mu=2e-3)


def data(n_samples: int) -> Tuple[np.ndarray, np.ndarray]:
    """(x (n_samples, 6), A (6, 6)) of the benchmark's mixture."""
    x, a, _ = mixtures.mixture(n_samples=n_samples, m=6, n_src=6, seed=0,
                               kinds=["uniform", "bimodal", "sine"])
    return x, a


def amari_after_fit(b0: torch.Tensor, x: torch.Tensor, a: torch.Tensor, *, block: int,
                    epochs: int, execution: Execution) -> float:
    """Amari distance to A of B after `epochs` of EASI from B₀ over x."""
    b = easi.easi_fit(b0, x, CFG, block_size=block, epochs=epochs, execution=execution)
    return float(easi.amari_distance(b, a))


def run(fast: bool = True, execution: Optional[Execution] = None):
    exe = execution if execution is not None else TORCH
    dev = exe.torch_device()
    x, a = (torch.from_numpy(t).to(dev) for t in data(20000 if fast else 60000))
    rows = []
    for block, epochs in BLOCKS:
        b0 = easi.init_b(torch.Generator().manual_seed(1), CFG).to(dev)
        t0 = time.perf_counter()
        amari = amari_after_fit(b0, x, a, block=block, execution=exe,
                                epochs=epochs if not fast else max(2, epochs // 2))
        dt = (time.perf_counter() - t0) * 1e6
        rows.append((f"ica/amari_block{block}", dt, f"amari={amari:.4f}"))
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
