from repro_torch.checkpoint.manager import CheckpointManager, config_hash, leaf_hash

__all__ = ["CheckpointManager", "config_hash", "leaf_hash"]
