from repro_torch.data import mixtures, synthetic, waveform

__all__ = ["mixtures", "synthetic", "waveform"]
