"""Quickstart: the paper's technique in a few lines.

The port of `examples/quickstart.py`, on the card by default:

    python -m repro_torch.experiments.quickstart [--backend kernel] [--device cpu]

Composes the reconfigurable DR datapath from stages (random projection ->
EASI), trains it unsupervised on a synthetic 16-dim mixture of 4
independent sources, and shows that the learned 4-dim representation
separates sources (Amari distance) at half the adaptive-stage cost of
full-width EASI.  Where the reference trains a vmapped ensemble of four
models, this trains four independent models one after another (the
ensemble is not ported).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import easi
from repro_torch.data import mixtures
from repro_torch.dr import DRModel, EASIStage, Execution, RPStage


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("torch", "kernel"), default="torch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    exe = Execution(backend=args.backend, device=args.device)
    dev = exe.torch_device()

    # 1. data: x = A s, 16 observed dims, 4 independent non-Gaussian sources
    x, a_true, _ = mixtures.mixture(n_samples=30000, m=16, n_src=4, seed=0,
                                    kinds=["uniform", "bimodal", "sine"])
    x, a_true = torch.from_numpy(x).to(dev), torch.from_numpy(a_true).to(dev)

    # 2. compose the datapath: RP 16->8 (static ternary), EASI 8->4.
    #    EASIStage.full keeps Eq. 6's second-order term — the adaptive stage
    #    still runs at HALF the width (p=8 not m=16), which is where the
    #    paper's resource saving lives.
    model = DRModel(stages=(RPStage(16, 8), EASIStage.full(8, 4, mu=1e-3)),
                    execution=exe, block_size=32)
    state = model.init(torch.Generator().manual_seed(0))
    print(f"RP matrix: int8 {tuple(state.r.shape)}, "
          f"{float((state.r != 0).float().mean()):.3f} dense")
    full_width = DRModel(stages=(EASIStage.full(16, 4),))
    print(f"EASI stage: {tuple(state.b.shape)} (vs {(4, 16)} for full-width EASI -> "
          f"{model.mac_counts()['easi_macs']:.0f} MACs/sample vs "
          f"{full_width.mac_counts()['easi_macs']:.0f})")

    # 3. unsupervised streaming fit (the paper's training phase)
    state = model.fit(state, x, epochs=10)

    # 4. deploy: transform new data (the paper's inference phase)
    y = model.transform(state, x)
    print(f"reduced features: {tuple(y.shape)}, "
          f"whiteness KL = {float(easi.whiteness_kl(y)):.3f}")

    # 5. quality: the effective separator B·(scale·R) should invert the mixing
    scale = model.stages[0].rp_cfg(model.execution).scale

    def amari(st):
        w_eff = st.b @ (st.r.to(torch.float32) * scale)
        return float(easi.amari_distance(w_eff, a_true))

    print(f"Amari distance to true mixing: {amari(state):.4f} (0 = perfect, random ≈ 0.4)")

    # 6. four independent models, each from its own generator
    dists = [amari(model.fit(model.init(torch.Generator().manual_seed(1 + i)), x, epochs=10))
             for i in range(4)]
    print(f"4 independent models, Amari distances: {['%.3f' % d for d in dists]}")
    return {"amari": amari(state), "amari_models": dists}


if __name__ == "__main__":
    main()
