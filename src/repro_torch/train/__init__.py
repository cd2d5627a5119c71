"""Training utilities: the AdamW optimizer and its LR schedules, and the DR
front-end of the train step."""

from repro_torch.train import optimizer, train_step

__all__ = ["optimizer", "train_step"]
