"""Training: the AdamW optimizer and its LR schedules, the single-device
train step (loss, autograd, AdamW, the DR front-end co-trained inside it)
and the fault-tolerant trainer."""

from repro_torch.train import optimizer, train_step, trainer

__all__ = ["optimizer", "train_step", "trainer"]
