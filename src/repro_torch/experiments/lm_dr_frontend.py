"""The paper's technique as an LM front-end, trained on a mesh.

The port of `examples/lm_dr_frontend.py`, on the card by default:

    python -m repro_torch.experiments.lm_dr_frontend [--steps 120] [--device cpu]

A HuBERT-style audio encoder (reduced config) whose input frames pass
through an RP→EASI unit co-trained (streaming, unsupervised) inside the
supervised train step, over `make_smoke_mesh()`.  Prints the loss curve
with and without the DR front-end and the DR unit's whitening progress.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import dr_unit, easi
from repro_torch.core.execution import Execution
from repro_torch.data import synthetic
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models.config import DRFrontendSpec
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts_mod


def run(arch_cfg, steps, *, execution: Execution, seed: int = 0, tag: str = "", log=print):
    dev = execution.torch_device()
    tcfg = ts_mod.TrainConfig(arch=arch_cfg, opt=opt_mod.AdamWConfig(lr=3e-4), seed=seed)
    state = ts_mod.init_state(torch.Generator(device=dev).manual_seed(seed), tcfg,
                              execution=execution)
    data = synthetic.TokenStreamConfig(vocab_size=arch_cfg.vocab_size, seq_len=64,
                                       global_batch=8, seed=seed)

    def make_batch(step):
        b = synthetic.token_batch(data, step)
        frames = synthetic.feature_batch(arch_cfg.frontend_dim,
                                         data.global_batch * data.seq_len, step, seed=seed)
        return {"tokens": b["tokens"] % arch_cfg.vocab_size,
                "frames": frames.reshape(data.global_batch, data.seq_len,
                                         arch_cfg.frontend_dim)}

    mesh = make_smoke_mesh(device=execution.device)
    state = ts_mod.lay_out_state(state, mesh)
    step_fn = ts_mod.make_train_step(tcfg, execution=execution, mesh=mesh)
    losses = []
    for i in range(steps):
        state, metrics = step_fn(state, make_batch(i))
        losses.append(float(metrics["loss"]))
        if i % 20 == 0:
            extra = ""
            if state.dr is not None:
                feats = make_batch(i)["frames"].reshape(-1, arch_cfg.frontend_dim).to(dev)
                red = dr_unit.transform(state.dr, ts_mod._dr_cfg(arch_cfg), feats[:2048],
                                        execution=execution)
                extra = f"  DR whiteness KL={float(easi.whiteness_kl(red)):.3f}"
            log(f"[{tag}] step {i:4d} loss {losses[-1]:.4f}{extra}")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    exe = Execution(backend="kernel", device=args.device)

    base = registry.get_smoke("hubert_xlarge")
    print(f"== baseline (frontend_dim={base.frontend_dim} -> d_model direct) ==")
    l0 = run(base, args.steps, execution=exe, tag="base")
    with_dr = dataclasses.replace(base, dr_frontend=DRFrontendSpec(kind="rp_easi", p=16, n=8,
                                                                   mu=2e-4))
    print(f"\n== with RP→EASI front-end ({base.frontend_dim} -> 16 -> 8) ==")
    l1 = run(with_dr, args.steps, execution=exe, tag="rp_easi")
    print(f"\nfinal-20-step mean loss: baseline {np.mean(l0[-20:]):.4f} vs DR front-end "
          f"{np.mean(l1[-20:]):.4f} (frontend params {base.frontend_dim}×d vs 8×d — "
          f"{base.frontend_dim / 8:.0f}× smaller)")
    return l0, l1


if __name__ == "__main__":
    main()
