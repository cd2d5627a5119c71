"""Training utilities: the AdamW optimizer and its LR schedules."""

from repro_torch.train import optimizer

__all__ = ["optimizer"]
