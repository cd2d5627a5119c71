from repro_torch.checkpoint.manager import config_hash

__all__ = ["config_hash"]
