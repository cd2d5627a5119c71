"""Architecture configs of the LM zoo, copied from the JAX package's
`configs/<arch>.py` (data only, over the port's own `ArchConfig`).

`repro_torch.configs.registry.get(arch_id)` returns the full-size config and
`get_smoke(arch_id)` the reduced same-family config the CPU tests use.  The
paper's experiment config (`waveform_paper.py`) is not ported yet (ROADMAP
A6).
"""
