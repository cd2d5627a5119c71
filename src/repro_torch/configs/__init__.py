"""Architecture configs of the LM zoo, copied from the JAX package's
`configs/<arch>.py` (data only, over the port's own `ArchConfig`).

`repro_torch.configs.registry.get(arch_id)` returns the full-size config and
`get_smoke(arch_id)` the reduced same-family config the CPU tests use.
`waveform_paper` holds the paper's own experiment: the Table I rows on
Waveform-V2, the ablations, a 3-stage cascade and the Table II pair.
"""
