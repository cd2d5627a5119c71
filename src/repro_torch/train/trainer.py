"""Fault-tolerant training loop: auto-resume, deterministic data, straggler
watchdog, preemption-safe checkpointing.

The JAX package's `train/trainer.py`, on one card or over a mesh
(`mesh=`: the state laid out by `train_step.state_specs`, the meshed
step, checkpoints gathered and written by rank 0; a restore lays every leaf
out for the CURRENT mesh, whatever mesh saved it).  Restart contract:
batches are a pure function of (seed, step) (`data.synthetic`), so resuming
from step k replays nothing and skips nothing.  The trainer restores the
newest valid checkpoint (quarantining corrupt ones) into a freshly
initialised state and continues from there; the checkpoints use the
reference's format (`checkpoint.manager`).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointManager, config_hash
from repro_torch.core.execution import Execution
from repro_torch.data import synthetic
from repro_torch.train import train_step as ts_mod


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    train: ts_mod.TrainConfig
    total_steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    keep_n: int = 3
    log_every: int = 10
    # straggler watchdog: warn if a step takes > factor × EMA
    straggler_factor: float = 3.0
    straggler_min_steps: int = 5


class StragglerWatchdog:
    """Wall-clock per-step EMA; flags outlier steps.  The `on_straggler`
    hook is where a multi-host deployment would re-slice or swap in a hot
    spare; here it records and logs."""

    def __init__(self, factor: float, min_steps: int,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None):
        self.factor = factor
        self.min_steps = min_steps
        self.ema: Optional[float] = None
        self.count = 0
        self.events = []
        self.on_straggler = on_straggler

    def observe(self, step: int, dt: float) -> bool:
        flagged = False
        if self.ema is not None and self.count >= self.min_steps \
                and dt > self.factor * self.ema:
            self.events.append((step, dt, self.ema))
            flagged = True
            if self.on_straggler:
                self.on_straggler(step, dt, self.ema)
        self.ema = dt if self.ema is None else 0.9 * self.ema + 0.1 * dt
        self.count += 1
        return flagged


def make_batch(arch, data_cfg: synthetic.TokenStreamConfig, step: int) -> Dict[str, torch.Tensor]:
    """The batch of `step`: tokens, plus frames (audio) or patches (vision)
    from the feature stream, as CPU tensors."""
    out = {"tokens": synthetic.token_batch(data_cfg, step)["tokens"]}
    b = data_cfg.global_batch
    if arch.frontend == "audio":
        out["frames"] = synthetic.feature_batch(
            arch.frontend_dim, b * data_cfg.seq_len, step, seed=data_cfg.seed).reshape(
            b, data_cfg.seq_len, arch.frontend_dim)
    elif arch.frontend == "vision":
        out["patches"] = synthetic.feature_batch(
            arch.frontend_dim, b * arch.frontend_seq, step, seed=data_cfg.seed).reshape(
            b, arch.frontend_seq, arch.frontend_dim)
    return out


def train(cfg: TrainerConfig, *, execution: Execution = Execution(), mesh=None,
          data_cfg: Optional[synthetic.TokenStreamConfig] = None,
          log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Run (or resume) to `total_steps`: {"state", "losses" (this call's
    steps), "watchdog" events, "final_step", "start_step"}."""
    arch = cfg.train.arch
    if data_cfg is None:
        data_cfg = synthetic.TokenStreamConfig(
            vocab_size=arch.vocab_size, seq_len=128, global_batch=8, seed=cfg.train.seed)
    dev = execution.torch_device()
    mgr = CheckpointManager(cfg.ckpt_dir, keep_n=cfg.keep_n,
                            config_tag=config_hash((arch, cfg.train.opt)))
    state = ts_mod.init_state(torch.Generator(device=dev).manual_seed(cfg.train.seed),
                              cfg.train, execution=execution)
    if mesh is not None:
        state = ts_mod.lay_out_state(state, mesh)
    # auto-resume: the newest valid checkpoint, each leaf where (and laid
    # out as) the fresh state's lies
    start_step, state = mgr.restore(state)
    start_step = 0 if start_step is None else start_step
    if start_step:
        log(f"[trainer] resumed from step {start_step}")

    step_fn = ts_mod.make_train_step(cfg.train, execution=execution, mesh=mesh)
    watchdog = StragglerWatchdog(cfg.straggler_factor, cfg.straggler_min_steps)
    losses = []
    try:
        for step in range(start_step, cfg.total_steps):
            t0 = time.monotonic()
            state, metrics = step_fn(state, make_batch(arch, data_cfg, step))
            losses.append(float(metrics["loss"]))    # waits for the step
            dt = time.monotonic() - t0
            if watchdog.observe(step, dt):
                log(f"[watchdog] straggler at step {step}: {dt:.3f}s vs EMA "
                    f"{watchdog.ema:.3f}s")
            if step % cfg.log_every == 0:
                log(f"[trainer] step {step} loss {losses[-1]:.4f} ({dt * 1e3:.0f} ms)")
            if (step + 1) % cfg.ckpt_every == 0 or (step + 1) == cfg.total_steps:
                mgr.save(step + 1, state)
    finally:
        mgr.wait()
    return {"state": state, "losses": losses, "watchdog": watchdog.events,
            "final_step": cfg.total_steps, "start_step": start_step}
