from repro_torch.data import waveform

__all__ = ["waveform"]
