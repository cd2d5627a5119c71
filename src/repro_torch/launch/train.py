"""Training driver.

    python -m repro_torch.launch.train --arch smollm_135m --smoke --steps 30 --device cpu
    python -m repro_torch.launch.train --arch h2o_danube3_4b --steps 100

The JAX package's `launch/train.py`: `--device` (the card unless it says
"cpu") is added; the kernel backend runs on the card (and its plain
versions on the CPU).  `--smoke` takes the config's reduced variant and one
micro-batch a step; otherwise the config's own `train_grad_accum`.
`--multi-pod` trains over `make_production_mesh(multi_pod=True)`: one
process per card, started by a launcher that sets `RANK`, `WORLD_SIZE`,
`MASTER_ADDR` and `MASTER_PORT` (512 ranks); without them it stops at once,
naming the world size it has and needs.  Otherwise one card, unmeshed.
"""

import argparse
import os
import tempfile

from repro_torch.configs import registry
from repro_torch.core.execution import Execution
from repro_torch.data import synthetic
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts_mod
from repro_torch.train import trainer as trainer_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    mesh = None
    if args.multi_pod:
        from repro_torch.launch.mesh import make_production_mesh

        mesh = make_production_mesh(multi_pod=True, device=args.device)

    cfg = registry.get_smoke(args.arch) if args.smoke else registry.get(args.arch)
    tcfg = ts_mod.TrainConfig(
        arch=cfg,
        opt=opt_mod.AdamWConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                                total_steps=args.steps),
        grad_accum=cfg.train_grad_accum if not args.smoke else 1,
    )
    trainer_cfg = trainer_mod.TrainerConfig(
        train=tcfg, total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every)
    data_cfg = synthetic.TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, seed=tcfg.seed)
    res = trainer_mod.train(trainer_cfg, execution=Execution(backend="kernel",
                                                             device=args.device),
                            mesh=mesh, data_cfg=data_cfg)
    print(f"done: final loss {res['losses'][-1]:.4f} over {args.steps} steps; "
          f"straggler events: {len(res['watchdog'])}")
    return res


if __name__ == "__main__":
    main()
