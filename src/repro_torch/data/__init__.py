from repro_torch.data import mixtures, waveform

__all__ = ["mixtures", "waveform"]
