"""repro_torch — `repro` ported to PyTorch and CUDA: the DR datapath, the
paper's experiment, the serving engine, and LM serving and training for
every family of the zoo.

A package beside the JAX reference, mirroring its layout file for file:

  core       — random projection, EASI, whitening, the Execution policy
  kernels    — hand-written CUDA kernels (sm_90a) and their plain versions
  dr         — Stage / RPStage / EASIStage / DRModel
  data       — the Waveform-V2 generator, mixtures, the synthetic LM streams
  models     — ArchConfig, blocks, the transformer / RWKV-6 / Zamba-2
               families, the model api (serving and the training loss)
  configs    — the LM zoo's architecture configs (data only)
  serve      — the DR serving engine and the LM serving steps
  train      — AdamW, the train step, the trainer
  checkpoint — the checkpoint manager (the reference's on-disk format)
  launch     — the training CLI
  bridge     — numpy ↔ torch for model states, LM parameters, train states

It imports torch, numpy and the standard library, never JAX and nothing of
`repro`.  Entry points run on the CUDA card unless the caller passes
`device="cpu"` in its `Execution`.
"""
